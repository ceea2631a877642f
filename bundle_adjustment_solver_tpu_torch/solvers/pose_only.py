"""Batched pose-only (motion-only) bundle adjustment: the fused lockstep
Gauss-Newton solvers of all four modes.

Counterpart of the fused batched part of the JAX package's
`solvers/pose_only.py` (the reference solves one frame per call,
core/pose_only_bundle_adjustment_solver.cpp:8-900; here B independent
frames iterate in lockstep, one kernel launch for the stats of every frame
per iteration):

  - `solve_monocular_6dof_batched`       (cpp:8-170)
  - `solve_stereo_6dof_batched`          (cpp:172-399)
  - `solve_monocular_planar3dof_batched` (cpp:401-615)
  - `solve_stereo_planar3dof_batched`    (cpp:617-900)

Semantics kept from the JAX package: fixed damping (1 + 1e-5) on the
diagonal (cpp:57), Manhattan-Huber weights, the correct robust cost
w (r_u^2 + r_v^2) scaled by 0.5 / n (mono) or 2 / (n_l + n_r) (stereo),
update before the convergence test, per-frame freezing once a frame is
done, info rows skipped on the converging iteration, a debug pose pushed
every iteration, `record_history=False` keeping one row (the reference's
`summary == nullptr` mode), final-iteration outlier masks, and
`success = False` for a frame whose pose ends non-finite (a valid point at
z = 0 does that to its frame only).

Not here: sticky `outlier_mask='reference'` masks, a per-frame rig
(B, 4, 4) and a per-frame `base_to_camera`. The JAX package sends those to
its vmapped single-frame solvers, which the single-frame pose-only slice of
this port brings; here they raise `NotImplementedError`. `Options.pallas`
is ignored: these entry points always run the fused loop, with the CUDA
kernels on CUDA tensors and their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops import sym6
from ..ops.cuda import pose_only_batched as BK
from ..ops.lie import compose, inverse_se3, planar_to_se3, se3_to_planar
from ..ops.projection import residual_and_weight
from ..options import IterationStatus, Options
from ..summary import (
    INFO_ABS_STEP,
    INFO_AVG_REPROJ,
    INFO_COST,
    INFO_COST_CHANGE,
    INFO_DAMPING,
    INFO_NUM_COLS,
    INFO_STATUS,
)

# The reference's pose-only solvers never adapt their damping (cpp:57).
_FIXED_LAMBDA = 1e-5

_SINGLE_FRAME = ("the single-frame pose-only solvers, which a later slice "
                 "of the port brings")


class PoseOnlyResult(NamedTuple):
    """Result of a batched pose-only solve; every field has a leading (B,)
    frame axis."""

    pose: torch.Tensor  # (B, 4, 4) optimized user-facing pose
    mask_inlier: torch.Tensor  # (B, P) bool, left camera
    mask_inlier_right: torch.Tensor  # (B, P) bool (== mask_inlier for mono)
    success: torch.Tensor  # (B,) bool: the pose is finite (cpp:159-167)
    converged: torch.Tensor  # (B,) bool
    num_iterations: torch.Tensor  # (B,) int32: iterations executed
    info: torch.Tensor  # (B, hist, INFO_NUM_COLS)
    num_info: torch.Tensor  # (B,) int32: valid rows in `info`
    debug_poses: torch.Tensor  # (B, hist, 4, 4) per-iteration pose trace
    num_debug: torch.Tensor  # (B,) int32


class _BatchCarry(NamedTuple):
    """Lockstep per-frame state. `state` is the mode's parameters: (12, B)
    pose rows for 6-DoF, theta (B, 3) for planar."""

    state: torch.Tensor
    err_prev: torch.Tensor  # (B,)
    it_b: torch.Tensor  # (B,) per-frame executed iterations
    done: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)
    info: torch.Tensor  # (B, hist, INFO_NUM_COLS)
    num_info: torch.Tensor  # (B,)
    debug_R: torch.Tensor  # (B, hist, 3, 3)
    debug_t: torch.Tensor  # (B, hist, 3)


def _to_Rt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def _to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _masked_state(active, new, old):
    """Select new for active frames; frames lie along the first axis."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def _fused_batch_loop(stats_fn, solve_fn, update_fn, debug_fn, state0, inv_n,
                      err_scale, options: Options, B: int, mask_fn=None):
    """The shared lockstep GN loop of the fused batched solvers.

    Mode-specific pieces: `stats_fn(state) -> (Atri, g, err_sum)` runs the
    stats kernel, `solve_fn(Atri, g) -> delta` the damped closed-form solve,
    `update_fn(state, delta)` applies the step, and `debug_fn(state) ->
    (dbg_R (B, 3, 3), dbg_t (B, 3))` gives the user-facing debug pose.
    Per-frame freezing, info and debug recording and the convergence flags
    follow the JAX package's `_fused_batch_loop`. The JAX loop is a
    `while_loop(any(not done))`; here it is a Python loop that reads the
    done flags from the device after every iteration and stops after at
    most max_iter iterations, by which every frame is done. The carry's
    history buffers are updated in place.
    """
    max_iter = options.iteration_handle.max_num_iterations
    thr_step = options.convergence_handle.threshold_step_size
    thr_cost = options.convergence_handle.threshold_cost_change
    hist = max_iter if options.record_history else 1
    if mask_fn is None:
        mask_fn = _masked_state
    dev = inv_n.device
    f32, i32 = torch.float32, torch.int32
    bidx = torch.arange(B, device=dev)
    update = float(int(IterationStatus.UPDATE))

    def body(c: _BatchCarry) -> _BatchCarry:
        Atri, g, err_sum = stats_fn(c.state)
        delta = solve_fn(Atri, g)  # (B, d)
        state_new = update_fn(c.state, delta)
        err_curr = err_sum * err_scale * inv_n
        step_norm = torch.linalg.vector_norm(delta, dim=-1)
        delta_err = torch.abs(err_curr - c.err_prev)
        conv_now = (step_norm < thr_step) | (delta_err < thr_cost)
        at_last = c.it_b == max_iter - 1
        active = ~c.done

        row = torch.zeros((B, INFO_NUM_COLS), dtype=f32, device=dev)
        row[:, INFO_COST] = err_curr
        row[:, INFO_COST_CHANGE] = delta_err
        row[:, INFO_AVG_REPROJ] = err_curr
        row[:, INFO_ABS_STEP] = step_norm
        row[:, INFO_DAMPING] = -1.0
        row[:, INFO_STATUS] = update
        write = active & ~conv_now
        slot = torch.clamp(c.it_b, max=hist - 1).long()
        c.info[bidx, slot] = torch.where(write[:, None], row,
                                         c.info[bidx, slot])

        dbg_R, dbg_t = debug_fn(state_new)
        c.debug_R[bidx, slot] = torch.where(active[:, None, None], dbg_R,
                                            c.debug_R[bidx, slot])
        c.debug_t[bidx, slot] = torch.where(active[:, None], dbg_t,
                                            c.debug_t[bidx, slot])

        return _BatchCarry(
            state=mask_fn(active, state_new, c.state),
            err_prev=torch.where(active, err_curr, c.err_prev),
            it_b=c.it_b + active.to(i32),
            done=c.done | (active & (conv_now | at_last)),
            converged=torch.where(active, conv_now | ~at_last, c.converged),
            info=c.info,
            num_info=c.num_info + write.to(i32),
            debug_R=c.debug_R,
            debug_t=c.debug_t,
        )

    c = _BatchCarry(
        state=state0,
        err_prev=torch.full((B,), 1e10, dtype=f32, device=dev),
        it_b=torch.zeros((B,), dtype=i32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        converged=torch.ones((B,), dtype=torch.bool, device=dev),
        info=torch.zeros((B, hist, INFO_NUM_COLS), dtype=f32, device=dev),
        num_info=torch.zeros((B,), dtype=i32, device=dev),
        debug_R=torch.zeros((B, hist, 3, 3), dtype=f32, device=dev),
        debug_t=torch.zeros((B, hist, 3), dtype=f32, device=dev),
    )
    for _ in range(max_iter if B > 0 else 0):
        c = body(c)
        if bool(c.done.all()):
            break
    return c


def _fused_batch_result(carry: _BatchCarry, final_fn):
    """(pose_out (B, 4, 4), debug_poses) from the final carry;
    `final_fn(state) -> (R_out, t_out)` is the mode's write-back."""
    R_out, t_out = final_fn(carry.state)
    return _to_T(R_out, t_out), _to_T(carry.debug_R, carry.debug_t)


def _plane_state_hooks():
    """update/debug/mask hooks for the 6-DoF solvers, whose state is (12, B)
    pose rows (row-wise SE(3) math: elementwise work on (B,) rows)."""

    def update_fn(pose12, delta):  # delta (B, 6)
        return BK.add_front_se3_rows(pose12, delta.T)

    def debug_fn(pose12):
        # Inverse pose in row form, then one transpose for the (B, 3, 3)
        # debug and result consumers.
        R = [pose12[k] for k in range(9)]
        t = [pose12[9 + k] for k in range(3)]
        Rt_rows = [R[0], R[3], R[6], R[1], R[4], R[7], R[2], R[5], R[8]]
        t_inv = [
            -(R[i] * t[0] + R[3 + i] * t[1] + R[6 + i] * t[2])
            for i in range(3)
        ]
        return BK.pose_rows_to_Rt(torch.stack(Rt_rows + t_inv))

    def mask_fn(active, new, old):
        return torch.where(active[None, :], new, old)

    return update_fn, debug_fn, mask_fn


def _solve6(Atri, g):
    """Damped closed-form batched 6x6 solve on flat (B, 21) triangles."""
    Cinv = sym6.inverse_tri6(sym6.tri6_damp(Atri, _FIXED_LAMBDA))
    return sym6.tri6_matvec(Cinv, -g)


def _solve3(Atri, g):
    """Damped closed-form batched 3x3 solve on flat (B, 6) columns
    [xx, xy, xz, yy, yz, zz] (sym6._inv_sym3_cols order). The diagonal
    columns 0, 3, 5 are scaled one by one: no index or scale tensor is
    copied to the card inside the loop."""
    damp = 1.0 + _FIXED_LAMBDA
    c = [Atri[:, k] * damp if k in (0, 3, 5) else Atri[:, k]
         for k in range(6)]
    i0, i1, i2, i3, i4, i5 = sym6._inv_sym3_cols(c)
    g0, g1, g2 = -g[:, 0], -g[:, 1], -g[:, 2]
    return torch.stack(
        [
            i0 * g0 + i1 * g1 + i2 * g2,
            i1 * g0 + i3 * g1 + i4 * g2,
            i2 * g0 + i4 * g1 + i5 * g2,
        ],
        dim=-1,
    )


def _planar_prior(pose_base_to_camera, pose_world_to_last,
                  pose_world_to_current):
    """Planar prior theta = (x, y, psi) of base2<-base1 from the camera-pose
    prior chain T_b2b1 = T_bc (T_wc2)^-1 T_wc1 T_cb (reference
    cpp:449-460)."""
    R_bc, t_bc = _to_Rt(pose_base_to_camera)
    R_cb, t_cb = inverse_se3(R_bc, t_bc)
    R_wc2, t_wc2 = _to_Rt(pose_world_to_current)
    R_c2w, t_c2w = inverse_se3(R_wc2, t_wc2)
    R_wc1, t_wc1 = _to_Rt(pose_world_to_last)
    R_c2c1, t_c2c1 = compose(R_c2w, t_c2w, R_wc1, t_wc1)
    R_tmp, t_tmp = compose(R_bc, t_bc, R_c2c1, t_c2c1)
    R_b2b1, t_b2b1 = compose(R_tmp, t_tmp, R_cb, t_cb)
    return se3_to_planar(R_b2b1, t_b2b1), (R_cb, t_cb), (R_bc, t_bc)


def _planar_pose_rows(theta, A_r, A_t):
    """(B, 3) planar params -> ((12, B) camera<-base1 pose rows, (2, B)
    cos/sin rows) by row-wise compose with the camera<-base extrinsic, given
    as 9 + 3 scalar entries `A_r`, `A_t`."""
    x, y, psi = theta[:, 0], theta[:, 1], theta[:, 2]
    c, s = torch.cos(psi), torch.sin(psi)
    zero = torch.zeros_like(c)
    Rp = [c, -s, zero, s, c, zero, zero, zero, torch.ones_like(c)]
    tp = [x, y, zero]
    Cr, Ct = BK.compose_rows(A_r, A_t, Rp, tp)
    return torch.stack(Cr + Ct), torch.stack([c, s])


def _planar_update_batched(theta, delta):
    """Batched left-compose of planar deltas (cpp:536-547)."""
    dx, dy, dpsi = delta[:, 0], delta[:, 1], delta[:, 2]
    c, s = torch.cos(dpsi), torch.sin(dpsi)
    x, y, psi = theta[:, 0], theta[:, 1], theta[:, 2]
    return torch.stack(
        [c * x - s * y + dx, s * x + c * y + dy, psi + dpsi], dim=-1
    )


# ---------------------------------------------------------------------------
# Shared pieces of the four solvers
# ---------------------------------------------------------------------------

# Each mode's stats kernel and the size of its J^T W J triangle.
_STATS = {
    "mono": (BK.batched_mono_gn_stats, 21),
    "stereo": (BK.batched_stereo_gn_stats, 21),
    "planar_mono": (BK.batched_planar_mono_gn_stats, 6),
    "planar_stereo": (BK.batched_planar_stereo_gn_stats, 6),
}


class BatchedFrames(NamedTuple):
    """One solve's frames on its device, laid out once for the stats kernel
    of `mode`, with what the final masks and the planar maps need. Per
    camera (left, then right for stereo) the tuples hold its pixels, its
    validity (the right camera's: valid and matched) and its intrinsics."""

    mode: str
    points: torch.Tensor  # (B, P, 3)
    pixels: tuple  # (B, P, 2) per camera
    valid: tuple  # (B, P) bool per camera
    intrinsics: tuple  # (4,) or (B, 4) per camera
    obs: torch.Tensor  # (6 | 9, B, P) observation planes of the kernel
    intr8: torch.Tensor  # (8, B) intrinsic rows of the kernel
    mats: tuple  # the kernel's shared (3, 4) host extrinsics, in its order
    inv_n: torch.Tensor  # (B,) 1 / the frame's observation count
    rig: tuple | None  # right<-left (R, t), stereo
    base: tuple | None  # (R_cb, t_cb, R_bc, t_bc), planar
    cb_entries: tuple | None  # R_cb, t_cb as 9 + 3 0-dim tensors, planar
    state0: torch.Tensor  # (12, B) camera<-world pose rows or (B, 3) theta


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _cam4(intr):
    """fx, fy, cx, cy of (4,) shared or (B, 4) per-frame intrinsics, shaped
    to broadcast over (B, P)."""
    return [intr[..., k, None] if intr.dim() == 2 else intr[k]
            for k in range(4)]


def _check_options(options: Options):
    if options.outlier_mask == "reference":
        raise NotImplementedError(
            "outlier_mask='reference' (sticky masks) needs the per-iteration "
            f"residual pass of {_SINGLE_FRAME}")


def _check_shared(name, T):
    if T.dim() == 3:
        raise NotImplementedError(
            f"a per-frame {name} (B, 4, 4) runs through {_SINGLE_FRAME}; "
            "the fused batched solvers take one shared (4, 4) extrinsic")


def _frames(mode, device, points, pixels_left, valid, intr_left, init,
            pixels_right=None, intr_right=None, pose_left_to_right=None,
            pose_base_to_camera=None) -> BatchedFrames:
    """Move a solve's inputs to its device and lay them out for `mode`'s
    stats kernel. `init` is (poses,) for 6-DoF and (poses_world_to_last,
    poses_world_to_current) for planar."""
    dev = resolve_device(device)
    points, pl = _f32(points, dev), _f32(pixels_left, dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    il = _f32(intr_left, dev)
    B = points.shape[0]
    vl = valid.to(torch.float32)
    rig, right_rows = None, [0.0] * 4
    pixels, valids, intr = (pl,), (valid,), (il,)
    if pixels_right is None:
        n_obs = vl.sum(-1)
        obs = BK.obs_planes(points, pl, vl)
    else:
        T_lr = _f32(pose_left_to_right, dev)
        _check_shared("pose_left_to_right", T_lr)
        rig = inverse_se3(*_to_Rt(T_lr))
        pr, ir = _f32(pixels_right, dev), _f32(intr_right, dev)
        # A negative coordinate marks no match.
        valid_r = valid & (pr[..., 0] >= 0) & (pr[..., 1] >= 0)
        vr = valid_r.to(torch.float32)
        n_obs = vl.sum(-1) + vr.sum(-1)
        obs = BK.obs_planes(points, pl, vl, pr, vr)
        right_rows = [ir[..., k] for k in range(4)]
        pixels, valids, intr = (pl, pr), (valid, valid_r), (il, ir)
    intr8 = BK.intr_rows([il[..., k] for k in range(4)] + right_rows, B, dev)

    base = cb_entries = None
    if mode.startswith("planar"):
        bc = _f32(pose_base_to_camera, dev)
        _check_shared("pose_base_to_camera", bc)
        state0, (R_cb, t_cb), (R_bc, t_bc) = _planar_prior(
            bc, *[_f32(T, dev) for T in init])
        base = (R_cb, t_cb, R_bc, t_bc)
        # The camera<-base entries as 0-dim tensors, taken once for the loop.
        cb_entries = ([R_cb[i, j] for i in range(3) for j in range(3)],
                      [t_cb[i] for i in range(3)])
        mats = (BK.mat34(R_cb, t_cb),)
        if rig is not None:
            # The right camera through R_rl R_cb, zero translation column.
            mats += (BK.mat34(torch.matmul(rig[0], R_cb), torch.zeros_like(
                t_cb)), BK.mat34(*rig))
    else:
        state0 = BK.pose_rows(*inverse_se3(*_to_Rt(_f32(init[0], dev))))
        mats = () if rig is None else (BK.mat34(*rig),)
    return BatchedFrames(
        mode=mode, points=points, pixels=pixels, valid=valids,
        intrinsics=intr, obs=obs, intr8=intr8, mats=mats,
        inv_n=1.0 / torch.clamp(n_obs, min=1.0), rig=rig, base=base,
        cb_entries=cb_entries, state0=state0)


def batched_frames(mode, problem, device=None) -> BatchedFrames:
    """The frames of a batched problem dict as the solve of `mode` lays
    them out: the tensors of `convert.batched_problem_tensors` from one of
    the batched generators, plus a (B, P) bool `valid`; both cameras take
    `intrinsics`. `stats_args(frames, frames.state0, huber)` then gives the
    stats kernel's arguments at the solve's initial poses."""
    p = problem
    stereo = mode.endswith("stereo")
    init = ((p["poses_world_to_last"], p["poses_world_to_current_init"])
            if mode.startswith("planar") else (p["poses_initial"],))
    return _frames(
        mode, device, p["points"], p["pixels_left"], p["valid"],
        p["intrinsics"], init,
        pixels_right=p["pixels_right"] if stereo else None,
        intr_right=p["intrinsics"] if stereo else None,
        pose_left_to_right=p["pose_left_to_right"] if stereo else None,
        pose_base_to_camera=p.get("base_to_camera"))


def stats_args(frames: BatchedFrames, state, huber):
    """The arguments of `frames.mode`'s stats kernel at `state`: (12, B)
    camera<-world pose rows for 6-DoF, (B, 3) theta for planar."""
    if frames.base is None:
        return (state, frames.intr8) + frames.mats + (frames.obs, huber)
    pose12, psi2 = _planar_pose_rows(state, *frames.cb_entries)
    return (pose12, frames.intr8, psi2) + frames.mats + (frames.obs, huber)


def _warp_points(R, t, points):
    """(B, 3, 3), (B, 3) applied to (B, P, 3) points."""
    return torch.einsum("bij,bpj->bpi", R, points) + t[:, None, :]


def _solve(f: BatchedFrames, options: Options) -> PoseOnlyResult:
    """The fused lockstep solve of `f.mode`, then the final outlier masks."""
    huber = float(options.outlier_handle.threshold_huber_loss)
    thr_outlier = options.outlier_handle.threshold_outlier_rejection
    kernel, n = _STATS[f.mode]
    B = f.points.shape[0]

    def stats_fn(state):
        st = kernel(*stats_args(f, state, huber))
        return st[:, :n], st[:, n:-1], st[:, -1]

    if f.base is None:
        solve_fn = _solve6
        update_fn, debug_fn, mask_fn = _plane_state_hooks()
    else:
        R_cb, t_cb, R_bc, t_bc = f.base
        solve_fn, update_fn = _solve3, _planar_update_batched
        mask_fn = _masked_state

        def debug_fn(theta):
            Rn, tn = planar_to_se3(theta)
            return compose(*inverse_se3(Rn, tn), R_bc, t_bc)

    err_scale = 2.0 if f.rig is not None else 0.5
    carry = _fused_batch_loop(stats_fn, solve_fn, update_fn, debug_fn,
                              f.state0, f.inv_n, err_scale, options, B,
                              mask_fn=mask_fn)
    pose_out, debug_poses = _fused_batch_result(carry, debug_fn)

    # Final-iteration outlier masks, recomputed from the final pose.
    if f.base is None:
        R, t = BK.pose_rows_to_Rt(carry.state)
    else:
        R, t = compose(R_cb, t_cb, *planar_to_se3(carry.state))
    X = _warp_points(R, t, f.points)
    masks = []
    for cam, (pix, valid, intr) in enumerate(
            zip(f.pixels, f.valid, f.intrinsics)):
        if cam:
            X = torch.einsum("ij,bpj->bpi", f.rig[0], X) + f.rig[1]
        _, _, man = residual_and_weight(X, pix, *_cam4(intr), huber)
        masks.append(valid & (man < thr_outlier))
    return PoseOnlyResult(
        pose=pose_out,
        mask_inlier=masks[0],
        mask_inlier_right=masks[-1],
        success=torch.isfinite(pose_out).all(dim=2).all(dim=1),
        converged=carry.converged,
        num_iterations=carry.it_b,
        info=carry.info,
        num_info=carry.num_info,
        debug_poses=debug_poses,
        num_debug=carry.it_b,
    )


# ---------------------------------------------------------------------------
# Public entry points (the JAX package's argument order, plus `device`)
# ---------------------------------------------------------------------------


def solve_monocular_6dof_batched(points, pixels, valid, intrinsics, poses,
                                 options: Options, device=None
                                 ) -> PoseOnlyResult:
    """Batched mono 6-DoF over a leading frame axis.

    points (B, P, 3), pixels (B, P, 2), valid (B, P) bool, intrinsics (4,)
    shared or (B, 4) per frame, poses (B, 4, 4) initial world<-current
    guesses. Arrays or tensors; they are moved to `device` (the CUDA card
    unless the caller passes one, e.g. "cpu"). The stats of all frames come
    from one launch of the mono kernel per lockstep iteration.
    """
    _check_options(options)
    return _solve(_frames("mono", device, points, pixels, valid, intrinsics,
                          (poses,)), options)


def solve_stereo_6dof_batched(points, pixels_left, pixels_right, valid,
                              intrinsics_left, intrinsics_right,
                              pose_left_to_right, poses, options: Options,
                              device=None) -> PoseOnlyResult:
    """Batched stereo 6-DoF over a leading frame axis with one shared rig.

    As `solve_monocular_6dof_batched`, plus right pixels (B, P, 2) whose
    negative coordinates mark no match, right intrinsics, and the (4, 4)
    left->right rig extrinsic shared by every frame.
    """
    _check_options(options)
    return _solve(_frames("stereo", device, points, pixels_left, valid,
                          intrinsics_left, (poses,), pixels_right,
                          intrinsics_right, pose_left_to_right), options)


def solve_monocular_planar3dof_batched(points, pixels, valid, intrinsics,
                                       pose_base_to_camera,
                                       poses_world_to_last,
                                       poses_world_to_current,
                                       options: Options, device=None
                                       ) -> PoseOnlyResult:
    """Batched planar 3-DoF mono over a leading frame axis, with one shared
    (4, 4) base->camera extrinsic. points (B, P, 3) in each frame's base1
    frame; poses_world_to_last / poses_world_to_current (B, 4, 4) give the
    prior chain; the result is the world<-current camera pose."""
    _check_options(options)
    return _solve(_frames("planar_mono", device, points, pixels, valid,
                          intrinsics,
                          (poses_world_to_last, poses_world_to_current),
                          pose_base_to_camera=pose_base_to_camera), options)


def solve_stereo_planar3dof_batched(points, pixels_left, pixels_right, valid,
                                    intrinsics_left, intrinsics_right,
                                    pose_base_to_camera, pose_left_to_right,
                                    poses_world_to_last,
                                    poses_world_to_current, options: Options,
                                    device=None) -> PoseOnlyResult:
    """Batched planar 3-DoF stereo over a leading frame axis, with a shared
    rig and a shared base->camera extrinsic (see the mono planar entry)."""
    _check_options(options)
    return _solve(_frames("planar_stereo", device, points, pixels_left, valid,
                          intrinsics_left,
                          (poses_world_to_last, poses_world_to_current),
                          pixels_right, intrinsics_right, pose_left_to_right,
                          pose_base_to_camera), options)
