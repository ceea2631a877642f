"""Point-major full-BA kernels: wrappers, plain versions, and the tensor
glue around them.

Counterpart of the JAX package's `ops/pallas/full_ba_pm.py`. Three kernels
over the point-major layout (models/layout.py), written in CUDA C++ in
`csrc/full_ba_pm.cu`:

  * assembly (`assemble_pm_blocks`) -- one fused pass per LM iteration:
    gather each slot's pose row from the block's window, warp, project,
    Manhattan-Huber weight, analytic Jacobians, damped point blocks C / b /
    Cinv, per-slot coupling blocks U, and the pose-system partials (A, a,
    B Cinv b) scattered into per-block (P, 40) panels, finished by a small
    second-level sum (`_second_level`, a torch op);
  * Schur matvec (`matvec_pm_blocks`) -- gather x over the window,
    t = sum_slots U^T x, v = Cinv t, scatter U v back to (P, 8) panels,
    emit t for back-substitution; mode "rhs" uses t := b;
  * cost (`cost_pm_blocks`) -- residual-only pass reducing the reference
    cost metric (sum of residual L2 norms, full cpp:427), the robust
    squared cost, the raw squared error and the valid count to per-block
    partials.

Each kernel wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (the same math on the same planes, with indexing in place
of the TPU kernels' one-hot products) for CPU tensors; any other device
raises. `<wrapper>.launches` counts kernel launches and `<plain>.calls`
counts calls of the plain versions. Everything is float32.

Symmetric 3x3 component order: [xx, xy, xz, yy, yz, zz] (diag at 0, 3, 5).
U (pose 6 x point 3) component order: row-major e = a * 3 + c.
Cb plane rows: [0:6) damped C, [6:9) b, [9:15) Cinv, 15 slot-use count.
A-panel columns: [0:21) upper-tri A, [21:27) a, [27:33) B Cinv b (the
reduced-rhs correction, fused into the assembly scatter), rest padding.
"""

from __future__ import annotations

import ctypes

import torch

from ...models.layout import PMShape, PointMajorProblem
from ..sym6 import _TRI6, tri6_damp
from . import _build

A_COLS = 40  # 21 upper-tri A + 6 gradient a + 6 rhs-corr (B Cinv b), padded
X_COLS = 8  # x table and matvec panel: 6 pose components, padded
COST_COLS = 4  # [sum ||r||, sum w r^2, sum r^2, valid count]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ba_assemble_pm": [_P] * 12 + [_I, _I, _I, _I, _L, _I, _P],
    "ba_matvec_pm": [_P] * 7 + [_I, _I, _I, _L, _I, _I, _P],
    "ba_cost_pm": [_P] * 8 + [_I, _I, _I, _I, _L, _I, _P],
}


def _lib():
    return _build.library("full_ba_pm", _SIGNATURES)


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate what a kernel will read through a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_layout(pm: PointMajorProblem, shape: PMShape, device) -> None:
    Kp, C, Mp = shape.slots, shape.cams, shape.padded_points
    f32, i32 = torch.float32, torch.int32
    _expect(pm.obs_f32, "obs_f32", f32, (3 * Kp * C, Mp), device)
    _expect(pm.slot_pose, "slot_pose", i32, (Kp, Mp), device)
    _expect(pm.slot_opt, "slot_opt", i32, (Kp, Mp), device)
    _expect(pm.gbase, "gbase", i32, (shape.num_blocks,), device)
    _expect(pm.sbase, "sbase", i32, (shape.num_blocks,), device)


def _check_pose_table(pose_tbl, X, cam_tbl, scal, shape, device) -> None:
    f32 = torch.float32
    if pose_tbl.dim() != 2 or pose_tbl.shape[1] != 16 or (
        pose_tbl.shape[0] < shape.num_poses + shape.window
    ):
        raise ValueError("pose table must be (>= N + P, 16)")
    _expect(pose_tbl, "pose_tbl", f32, tuple(pose_tbl.shape), device)
    _expect(X, "X", f32, (4, shape.padded_points), device)
    _expect(cam_tbl, "cam_tbl", f32, (shape.cams, 16), device)
    _expect(scal, "scal", f32, (2,), device)


# ---------------------------------------------------------------------------
# Tables and the second-level sum (tensor ops, as in the JAX package)
# ---------------------------------------------------------------------------


def pose_table(R_cw, t_cw, P):
    """Pack (N, 3, 3) + (N, 3) into a zero-padded (N + P, 16) gather table
    (R row-major in columns 0:9, t in 9:12). The solver carries this table
    across LM iterations; the +P rows keep every block's window in bounds."""
    N = R_cw.shape[0]
    tbl = torch.zeros((N + P, 16), dtype=torch.float32, device=R_cw.device)
    tbl[:N, :9] = R_cw.reshape(N, 9)
    tbl[:N, 9:12] = t_cw
    return tbl


def _cam_table(rig):
    """(C, 16) camera table: [fx, fy, cx, cy, R(9), t(3)]."""
    C = rig.fx.shape[0]
    return torch.cat(
        [
            rig.fx[:, None], rig.fy[:, None], rig.cx[:, None],
            rig.cy[:, None], rig.R_cam_from_ref.reshape(C, 9),
            rig.t_cam_from_ref,
        ],
        dim=1,
    ).to(torch.float32).contiguous()


def _scalars(lam, huber, device):
    """(2,) [lambda, huber] on the device: the kernels read both through a
    pointer, so a lambda that lives on the device needs no host round trip.
    Element writes (fills or device copies) avoid a host-to-device copy,
    which would synchronise the stream."""
    scal = torch.empty((2,), dtype=torch.float32, device=device)
    scal[0] = lam
    scal[1] = huber
    return scal


def _second_level(panels, sbase, n_opt, P, cols):
    """Finish a windowed scatter: (nblocks, P, cols) panels + per-block bases
    -> (n_opt, cols). Row j of block i's panel belongs to opt pose
    sbase[i] + j; rows past n_opt are padding."""
    nblocks = panels.shape[0]
    keys = (
        sbase.to(torch.int64)[:, None]
        + torch.arange(P, dtype=torch.int64, device=panels.device)[None, :]
    ).reshape(-1)
    out = torch.zeros(
        (n_opt + P, cols), dtype=torch.float32, device=panels.device
    )
    out.index_add_(0, keys, panels.reshape(nblocks * P, cols))
    return out[:n_opt]


# ---------------------------------------------------------------------------
# Plain versions: the kernels' math on the same planes, with indexing
# ---------------------------------------------------------------------------


def _window_rows(tbl, idx, base, bm, P):
    """(width, Kp, Mp): row `idx` of `tbl` for every slot whose offset from
    its block's window base lies in [0, P), zeros elsewhere (padding and
    fixed slots) -- what the kernels read from their staged window."""
    lane_base = base.to(torch.int64).repeat_interleave(bm)  # (Mp,)
    idx = idx.to(torch.int64)
    local = idx - lane_base
    ok = (local >= 0) & (local < P)
    rows = tbl[torch.where(ok, idx, torch.zeros_like(idx))]  # (Kp, Mp, w)
    rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    return rows.permute(2, 0, 1)


def _scatter_rows(contrib, idx, base, bm, P, nblocks):
    """(nblocks, P, cols) panels: contrib (cols, Kp, Mp) summed into row
    idx - base of its block's panel; offsets outside [0, P) are dropped."""
    cols, _, Mp = contrib.shape
    lane_base = base.to(torch.int64).repeat_interleave(bm)
    local = idx.to(torch.int64) - lane_base
    ok = (local >= 0) & (local < P)
    blk = torch.arange(Mp, device=contrib.device) // bm
    dest = (blk[None, :] * P + local)[ok]
    out = torch.zeros(
        (nblocks * P, cols), dtype=torch.float32, device=contrib.device
    )
    out.index_add_(0, dest, contrib[:, ok].T)
    return out.reshape(nblocks, P, cols)


def _warp_and_project(shape: PMShape, g, X, obs, cam_tbl, huber):
    """Shared residual-pass math on (Kp, Mp) component planes.

    g: (16, Kp, Mp) gathered pose rows [r00..r22, tx, ty, tz, pad].
    Returns per-camera dicts of residual / weight / projection terms and the
    slot-level reference-frame point coordinates.
    """
    Kp, C = shape.slots, shape.cams
    r = [g[i] for i in range(9)]
    t = [g[9 + i] for i in range(3)]
    x, y, z = X[0:1], X[1:2], X[2:3]  # (1, Mp) broadcasts over Kp

    # World -> rig reference frame (full cpp:744-745).
    xr = r[0] * x + r[1] * y + r[2] * z + t[0]
    yr = r[3] * x + r[4] * y + r[5] * z + t[1]
    zr = r[6] * x + r[7] * y + r[8] * z + t[2]

    KC = Kp * C
    per_cam = []
    for c in range(C):
        fx, fy, cx, cy = cam_tbl[c, 0], cam_tbl[c, 1], cam_tbl[c, 2], cam_tbl[c, 3]
        rc = [cam_tbl[c, 4 + i] for i in range(9)]
        tc = [cam_tbl[c, 13 + i] for i in range(3)]

        # Rig reference -> camera frame (full cpp:746-747).
        xc = rc[0] * xr + rc[1] * yr + rc[2] * zr + tc[0]
        yc = rc[3] * xr + rc[4] * yr + rc[5] * zr + tc[1]
        zc = rc[6] * xr + rc[7] * yr + rc[8] * zr + tc[2]

        pix_u = obs[c * Kp : (c + 1) * Kp]
        pix_v = obs[KC + c * Kp : KC + (c + 1) * Kp]
        valid = obs[2 * KC + c * Kp : 2 * KC + (c + 1) * Kp]

        # Guard padded slots (gathered zeros give zc == 0).
        zsafe = torch.where(zc.abs() > 1e-12, zc, torch.ones_like(zc))
        inv_z = 1.0 / zsafe
        ru = fx * xc * inv_z + cx - pix_u
        rv = fy * yc * inv_z + cy - pix_v
        man = ru.abs() + rv.abs()
        w = torch.where(
            man > huber, huber / torch.clamp_min(man, 1e-30),
            torch.ones_like(man),
        ) * valid
        per_cam.append(
            dict(xc=xc, yc=yc, inv_z=inv_z, ru=ru, rv=rv, w=w, valid=valid,
                 fx=fx, fy=fy, rc=rc)
        )
    return per_cam, (xr, yr, zr)


def _jacobians(cam, lever):
    """Analytic Q (pose, 6) and Rj (point, 3) rows for one camera
    (full cpp:770-828: projection Jacobian zero pattern, the
    [J_p | -J_p [X_ref]_x] pose block, Rj = J_p R_jw)."""
    xr, yr, zr, Rjw = lever
    fx, fy, rc = cam["fx"], cam["fy"], cam["rc"]
    inv_z, xc, yc = cam["inv_z"], cam["xc"], cam["yc"]

    fx_iz = fx * inv_z
    fy_iz = fy * inv_z
    du_dz = -fx_iz * xc * inv_z
    dv_dz = -fy_iz * yc * inv_z
    ju = [fx_iz * rc[0 + i] + du_dz * rc[6 + i] for i in range(3)]
    jv = [fy_iz * rc[3 + i] + dv_dz * rc[6 + i] for i in range(3)]

    # Rotation columns: J_p @ (-[X_ref]_x).
    qu_rot = [ju[2] * yr - ju[1] * zr, ju[0] * zr - ju[2] * xr,
              ju[1] * xr - ju[0] * yr]
    qv_rot = [jv[2] * yr - jv[1] * zr, jv[0] * zr - jv[2] * xr,
              jv[1] * xr - jv[0] * yr]
    Qu = ju + qu_rot
    Qv = jv + qv_rot
    Rju = [ju[0] * Rjw[0 + c] + ju[1] * Rjw[3 + c] + ju[2] * Rjw[6 + c]
           for c in range(3)]
    Rjv = [jv[0] * Rjw[0 + c] + jv[1] * Rjw[3 + c] + jv[2] * Rjw[6 + c]
           for c in range(3)]
    return Qu, Qv, Rju, Rjv


def _inverse_sym3(c, det_floor=1e-30):
    """Closed-form inverse of a symmetric 3x3 given as 6 planes
    [xx, xy, xz, yy, yz, zz]; zeros when singular."""
    a, b_, c_, d, e, f = c
    co00 = d * f - e * e
    co01 = c_ * e - b_ * f
    co02 = b_ * e - c_ * d
    det = a * co00 + b_ * co01 + c_ * co02
    ok = det > det_floor
    inv_det = torch.where(
        ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
        torch.zeros_like(det),
    )
    return [co00 * inv_det, co01 * inv_det, co02 * inv_det,
            (a * f - c_ * c_) * inv_det, (b_ * c_ - a * e) * inv_det,
            (a * d - b_ * b_) * inv_det]


def assemble_pm_blocks_plain(pm, shape: PMShape, pose_tbl, X, cam_tbl, scal):
    """Plain version of the assembly kernel: (U (18, Kp, Mp), Cb (16, Mp),
    panels (nblocks, P, A_COLS))."""
    assemble_pm_blocks_plain.calls += 1
    Kp, C, bm, P = shape.slots, shape.cams, shape.block_points, shape.window
    lam, huber = scal[0], scal[1]
    g = _window_rows(pose_tbl, pm.slot_pose, pm.gbase, bm, P)
    pmask = X[3:4]  # (1, Mp) 1.0 for optimizable landmarks
    per_cam, (xr, yr, zr) = _warp_and_project(
        shape, g, X, pm.obs_f32, cam_tbl, huber
    )
    Rjw = [g[i] for i in range(9)]

    zeros_kp = torch.zeros_like(xr)
    zeros_1 = torch.zeros_like(X[0:1])
    Csym = [zeros_1] * 6
    bvec = [zeros_1] * 3
    Ue = [zeros_kp] * 18
    Atri = [zeros_kp] * 21
    avec = [zeros_kp] * 6
    slot_use = zeros_kp

    for c in range(C):
        cam = per_cam[c]
        w, ru, rv = cam["w"], cam["ru"], cam["rv"]
        Qu, Qv, Rju, Rjv = _jacobians(cam, (xr, yr, zr, Rjw))
        slot_use = torch.maximum(slot_use, cam["valid"])
        # Point block C += w (Rju Rju^T + Rjv Rjv^T), gradient b -= w Rj^T r
        # (full cpp:812-823), reduced over slots.
        for n_, (a_, b2) in enumerate(
            [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        ):
            contrib = w * (Rju[a_] * Rju[b2] + Rjv[a_] * Rjv[b2])
            Csym[n_] = Csym[n_] + contrib.sum(0, keepdim=True)
        for a_ in range(3):
            contrib = -w * (Rju[a_] * ru + Rjv[a_] * rv)
            bvec[a_] = bvec[a_] + contrib.sum(0, keepdim=True)
        # Coupling U += w Q^T Rj (accumulated over cameras).
        for a_ in range(6):
            for b2 in range(3):
                Ue[a_ * 3 + b2] = Ue[a_ * 3 + b2] + w * (
                    Qu[a_] * Rju[b2] + Qv[a_] * Rjv[b2]
                )
        # Pose block A += w Q^T Q (upper-tri), a -= w Q^T r (cpp:795-809).
        for n_, (a_, b2) in enumerate(_TRI6):
            Atri[n_] = Atri[n_] + w * (Qu[a_] * Qu[b2] + Qv[a_] * Qv[b2])
        for a_ in range(6):
            avec[a_] = avec[a_] - w * (Qu[a_] * ru + Qv[a_] * rv)

    # Damped point blocks + closed-form inverse; fixed landmarks zero C.
    damp = 1.0 + lam
    Cd = [Csym[n_] * pmask for n_ in range(6)]
    Cd[0] = Cd[0] * damp
    Cd[3] = Cd[3] * damp
    Cd[5] = Cd[5] * damp
    Cinv = _inverse_sym3(Cd)
    bm_ = [bvec[a_] * pmask for a_ in range(3)]
    Cb = torch.cat(Cd + bm_ + Cinv + [slot_use.sum(0, keepdim=True)], dim=0)

    Um = [Ue[e] * pmask for e in range(18)]
    U = torch.stack(Um)

    # Reduced-rhs correction B Cinv b: v = Cinv (b * pmask), per slot U v.
    v0 = Cinv[0] * bm_[0] + Cinv[1] * bm_[1] + Cinv[2] * bm_[2]
    v1 = Cinv[1] * bm_[0] + Cinv[3] * bm_[1] + Cinv[4] * bm_[2]
    v2 = Cinv[2] * bm_[0] + Cinv[4] * bm_[1] + Cinv[5] * bm_[2]
    rhs_rows = [
        Um[a_ * 3] * v0 + Um[a_ * 3 + 1] * v1 + Um[a_ * 3 + 2] * v2
        for a_ in range(6)
    ]
    contrib = torch.stack(
        Atri + avec + rhs_rows + [zeros_kp] * (A_COLS - 33)
    )  # (A_COLS, Kp, Mp)
    panels = _scatter_rows(
        contrib, pm.slot_opt, pm.sbase, bm, P, shape.num_blocks
    )
    return U, Cb, panels


assemble_pm_blocks_plain.calls = 0


def matvec_pm_blocks_plain(pm, shape: PMShape, Cb, U, x_tbl, mode: str):
    """Plain version of the matvec kernel: (panels (nblocks, P, X_COLS),
    t (4, Mp))."""
    matvec_pm_blocks_plain.calls += 1
    bm, P = shape.block_points, shape.window
    Ul = [U[e] for e in range(18)]
    if mode == "rhs":
        t = [Cb[6 + c] for c in range(3)]
    else:
        xg = _window_rows(x_tbl, pm.slot_opt, pm.sbase, bm, P)  # (8, Kp, Mp)
        t = []
        for c in range(3):
            acc = Ul[c] * xg[0]
            for a_ in range(1, 6):
                acc = acc + Ul[a_ * 3 + c] * xg[a_]
            t.append(acc.sum(0))
    t_out = torch.stack(t + [torch.zeros_like(t[0])])

    ci = [Cb[9 + n_] for n_ in range(6)]
    v0 = ci[0] * t[0] + ci[1] * t[1] + ci[2] * t[2]
    v1 = ci[1] * t[0] + ci[3] * t[1] + ci[4] * t[2]
    v2 = ci[2] * t[0] + ci[4] * t[1] + ci[5] * t[2]
    rows = [Ul[a_ * 3] * v0 + Ul[a_ * 3 + 1] * v1 + Ul[a_ * 3 + 2] * v2
            for a_ in range(6)]
    contrib = torch.stack(rows + [torch.zeros_like(rows[0])] * 2)
    panels = _scatter_rows(
        contrib, pm.slot_opt, pm.sbase, bm, P, shape.num_blocks
    )
    return panels, t_out


matvec_pm_blocks_plain.calls = 0


def cost_pm_blocks_plain(pm, shape: PMShape, pose_tbl, X, cam_tbl, scal):
    """Plain version of the cost kernel: per-block partials
    (nblocks, COST_COLS)."""
    cost_pm_blocks_plain.calls += 1
    Kp, bm, P, nb = shape.slots, shape.block_points, shape.window, shape.num_blocks
    g = _window_rows(pose_tbl, pm.slot_pose, pm.gbase, bm, P)
    per_cam, _ = _warp_and_project(shape, g, X, pm.obs_f32, cam_tbl, scal[1])

    def per_block(v):
        return v.reshape(Kp, nb, bm).sum(dim=(0, 2))

    sums = [torch.zeros(nb, dtype=torch.float32, device=X.device)] * 4
    for cam in per_cam:
        ru, rv, w, valid = cam["ru"], cam["rv"], cam["w"], cam["valid"]
        sq = ru * ru + rv * rv
        sums[0] = sums[0] + per_block(valid * torch.sqrt(torch.clamp_min(sq, 0.0)))
        sums[1] = sums[1] + per_block(w * sq)
        sums[2] = sums[2] + per_block(valid * sq)
        sums[3] = sums[3] + per_block(valid)
    return torch.stack(sums, dim=1)


cost_pm_blocks_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def assemble_pm_blocks(pm: PointMajorProblem, shape: PMShape, pose_tbl, X,
                       cam_tbl, scal):
    """The assembly kernel on CUDA tensors, its plain version on CPU
    tensors. Returns (U (18, Kp, Mp), Cb (16, Mp), panels (nblocks, P,
    A_COLS)); `scal` is the (2,) [lambda, huber] tensor."""
    dev = pose_tbl.device
    _check_layout(pm, shape, dev)
    _check_pose_table(pose_tbl, X, cam_tbl, scal, shape, dev)
    if not _on_cuda(pose_tbl):
        return assemble_pm_blocks_plain(pm, shape, pose_tbl, X, cam_tbl, scal)
    Kp, C, bm, P = shape.slots, shape.cams, shape.block_points, shape.window
    Mp, nb = shape.padded_points, shape.num_blocks
    U = torch.empty((18, Kp, Mp), dtype=torch.float32, device=dev)
    Cb = torch.empty((16, Mp), dtype=torch.float32, device=dev)
    panels = torch.zeros((nb, P, A_COLS), dtype=torch.float32, device=dev)
    err = _lib().ba_assemble_pm(
        _ptr(pose_tbl), _ptr(cam_tbl), _ptr(scal), _ptr(pm.obs_f32),
        _ptr(pm.slot_pose), _ptr(pm.slot_opt), _ptr(X), _ptr(pm.gbase),
        _ptr(pm.sbase), _ptr(U), _ptr(Cb), _ptr(panels), Kp, C, bm, P, Mp,
        nb, _stream(),
    )
    _build.check(err, "ba_assemble_pm")
    assemble_pm_blocks.launches += 1
    return U, Cb, panels


assemble_pm_blocks.launches = 0


def matvec_pm_blocks(pm: PointMajorProblem, shape: PMShape, Cb, U, x_tbl,
                     mode: str):
    """The matvec kernel on CUDA tensors, its plain version on CPU tensors.
    x_tbl (n_opt + P, X_COLS); mode "matvec" or "rhs". Returns
    (panels (nblocks, P, X_COLS), t (4, Mp))."""
    if mode not in ("matvec", "rhs"):
        raise ValueError(f"mode must be 'matvec' or 'rhs', got {mode!r}")
    dev = U.device
    Kp, bm, P = shape.slots, shape.block_points, shape.window
    Mp, nb = shape.padded_points, shape.num_blocks
    _check_layout(pm, shape, dev)
    _expect(U, "U", torch.float32, (18, Kp, Mp), dev)
    _expect(Cb, "Cb", torch.float32, (16, Mp), dev)
    _expect(x_tbl, "x_tbl", torch.float32,
            (shape.num_opt_poses + P, X_COLS), dev)
    if not _on_cuda(U):
        return matvec_pm_blocks_plain(pm, shape, Cb, U, x_tbl, mode)
    panels = torch.zeros((nb, P, X_COLS), dtype=torch.float32, device=dev)
    t = torch.empty((4, Mp), dtype=torch.float32, device=dev)
    err = _lib().ba_matvec_pm(
        _ptr(x_tbl), _ptr(U), _ptr(Cb), _ptr(pm.slot_opt), _ptr(pm.sbase),
        _ptr(panels), _ptr(t), Kp, bm, P, Mp, nb, int(mode == "rhs"),
        _stream(),
    )
    _build.check(err, "ba_matvec_pm")
    matvec_pm_blocks.launches += 1
    return panels, t


matvec_pm_blocks.launches = 0


def cost_pm_blocks(pm: PointMajorProblem, shape: PMShape, pose_tbl, X,
                   cam_tbl, scal):
    """The cost kernel on CUDA tensors, its plain version on CPU tensors.
    Returns per-block partials (nblocks, COST_COLS)."""
    dev = pose_tbl.device
    _check_layout(pm, shape, dev)
    _check_pose_table(pose_tbl, X, cam_tbl, scal, shape, dev)
    if not _on_cuda(pose_tbl):
        return cost_pm_blocks_plain(pm, shape, pose_tbl, X, cam_tbl, scal)
    Kp, C, bm, P = shape.slots, shape.cams, shape.block_points, shape.window
    Mp, nb = shape.padded_points, shape.num_blocks
    partial = torch.empty((nb, COST_COLS), dtype=torch.float32, device=dev)
    err = _lib().ba_cost_pm(
        _ptr(pose_tbl), _ptr(cam_tbl), _ptr(scal), _ptr(pm.obs_f32),
        _ptr(pm.slot_pose), _ptr(X), _ptr(pm.gbase), _ptr(partial), Kp, C,
        bm, P, Mp, nb, _stream(),
    )
    _build.check(err, "ba_cost_pm")
    cost_pm_blocks.launches += 1
    return partial


cost_pm_blocks.launches = 0


# ---------------------------------------------------------------------------
# Entry points (the JAX package's names)
# ---------------------------------------------------------------------------


def assemble_pm_tbl(pm: PointMajorProblem, shape: PMShape, pose_tbl, X, rig,
                    lam, huber, u_dtype: str = "float32",
                    emit_schur: bool = False):
    """One assembly pass on a pre-packed (N + P, 16) pose table.

    Returns (flat, Cb, U): flat (n_opt, A_COLS) = [0:21) undamped upper-tri
    A, [21:27) gradient a, [27:33) B Cinv b; Cb (16, Mp) point-block planes;
    U (18, Kp, Mp) coupling planes."""
    if u_dtype != "float32":
        raise NotImplementedError(
            "coupling_dtype='bfloat16' (bf16 U planes) is not ported yet; "
            "it comes with the assembly kernel's bf16-U branch"
        )
    if emit_schur:
        raise NotImplementedError(
            "cg_precond='schur_jacobi' (the assembly kernel's emit_schur "
            "branch) is not ported yet"
        )
    dev = pose_tbl.device
    U, Cb, panels = assemble_pm_blocks(
        pm, shape, pose_tbl, X, _cam_table(rig), _scalars(lam, huber, dev)
    )
    flat = _second_level(
        panels, pm.sbase, shape.num_opt_poses, shape.window, A_COLS
    )
    return flat, Cb, U


def finish_pose_system_tri(flat, lam):
    """Flat pose-system partials -> (damped Atri (n_opt, 21), a (n_opt, 6),
    rhs (n_opt, 6) = a - B Cinv b), staying in the flat layout."""
    # (1 + lambda) diagonal damping on the pose blocks (cpp:838-846).
    a = flat[:, 21:27]
    rhs = a - flat[:, 27:33]
    return tri6_damp(flat[:, :21], lam), a, rhs


def matvec_corr_pm(pm: PointMajorProblem, shape: PMShape, Cb, U, x):
    """The B Cinv B^T x correction of S @ x. Returns (corr (n_opt, 6),
    t (4, Mp)) where t = B^T x per landmark (used for back-substitution)."""
    n_opt, P = shape.num_opt_poses, shape.window
    x_tbl = torch.zeros(
        (n_opt + P, X_COLS), dtype=torch.float32, device=U.device
    )
    x_tbl[:n_opt, :6] = x
    panels, t = matvec_pm_blocks(pm, shape, Cb, U, x_tbl, "matvec")
    corr = _second_level(panels, pm.sbase, n_opt, P, X_COLS)[:, :6]
    return corr, t


def rhs_corr_pm(pm: PointMajorProblem, shape: PMShape, Cb, U):
    """The B Cinv b correction of the reduced rhs."""
    n_opt, P = shape.num_opt_poses, shape.window
    x_tbl = torch.zeros(
        (n_opt + P, X_COLS), dtype=torch.float32, device=U.device
    )
    panels, _ = matvec_pm_blocks(pm, shape, Cb, U, x_tbl, "rhs")
    return _second_level(panels, pm.sbase, n_opt, P, X_COLS)[:, :6]


def cost_pm_tbl(pm: PointMajorProblem, shape: PMShape, pose_tbl, X, rig,
                huber):
    """Residual-only cost pass on a pre-packed (N + P, 16) pose table.
    Returns (sum ||r||, sum w r^2, sum r^2, valid count) as 0-dim float32
    tensors (scaled pixel units)."""
    dev = pose_tbl.device
    partial = cost_pm_blocks(
        pm, shape, pose_tbl, X, _cam_table(rig), _scalars(0.0, huber, dev)
    )
    tot = partial.sum(dim=0)
    return tot[0], tot[1], tot[2], tot[3]
