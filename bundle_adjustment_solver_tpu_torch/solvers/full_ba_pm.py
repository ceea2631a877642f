"""Point-major full-BA solver on PyTorch tensors and the CUDA kernels.

Counterpart of the JAX package's `solvers/full_ba_pm.py`: the same
algorithm and trust-region semantics as the reference's
FullBundleAdjustmentSolver::Solve (core/full_bundle_adjustment_solver.cpp:
630-1044), on the point-major layout (models/layout.py) with the kernels of
ops/cuda/:

  * one assembly kernel per LM iteration builds the damped block normal
    equations (A, a, C, Cinv, b, U) in a single fused pass;
  * the reduced camera system is solved matrix-free with block-Jacobi PCG
    whose S @ x product is one matvec kernel per CG iteration, and whose
    pose-side algebra is one fused step kernel per CG iteration
    (`Options.cg_fused_step`, the default);
  * back-substitution reuses the matvec's t = B^T x output:
    y = Cinv (b - t);
  * the quadratic-model decrease needs no extra observation pass:
    B^T x == b - C y identically (from the back-substitution), so
    model = -(a^T x + x^T A x + b^T y + y^T C y + 2 y^T (b - C y));
  * candidate costs come from the residual-only cost kernel.

The loops are Python loops. Where the JAX package tests its while_loop
conditions on the device, this port reads each condition to the host with
one `.item()`: one per CG iteration (the residual test) and one per LM
iteration (the done flag). Moving the loops onto the device is later work.
Everything else stays on the device, including lambda, the costs and the
trust-region decision.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.camera import CameraRig
from ..models.layout import PMShape, PointMajorProblem, build_point_major
from ..models.problem import FinalizedProblem, ProblemShape
from ..ops.cuda import full_ba_pm as K
from ..ops.cuda.cg_step import (
    MAX_FUSED_POSES,
    cg_pose_step,
    padded_poses,
    plane_sym6_matvec,
    to_planes,
)
from ..ops.lie import compose_flat, inverse_se3, se3_exp
from ..ops.sym6 import inverse_tri6, tri6_matvec
from ..options import IterationStatus, Options, SolverType
from ..summary import (
    INFO_ABS_GRADIENT,
    INFO_ABS_STEP,
    INFO_AVG_REPROJ,
    INFO_CG_ITERS,
    INFO_COST,
    INFO_COST_CHANGE,
    INFO_DAMPING,
    INFO_NUM_COLS,
    INFO_STATUS,
    Summary,
)
from .full_ba import FullBAState, _GN_LAMBDA, _cg_tolerance


class _Carry(NamedTuple):
    # Poses live in the packed (N + P, 16) gather-table form the kernels
    # consume (R row-major in cols 0:9, t in 9:12, rest zero).
    tbl: torch.Tensor
    X: torch.Tensor  # (4, Mp) point-major (row 3 = opt mask, never changes)
    lam: torch.Tensor
    prev_cost: torch.Tensor
    it: int
    done: torch.Tensor
    converged: torch.Tensor
    info: torch.Tensor
    num_info: int
    # Inner-CG state across LM iterations: previous pose step (warm start),
    # previous reduced-rhs norm and forcing tolerance (Eisenstat-Walker).
    x_prev: torch.Tensor  # (n_opt, 6)
    rhs_norm_prev: torch.Tensor  # ()
    eta_prev: torch.Tensor  # ()


def pm_problem_from_arrays(
    cameras,
    poses_world_to_camera: np.ndarray,  # (N, 4, 4)
    points: np.ndarray,  # (M, 3)
    obs_cam: np.ndarray,
    obs_pose: np.ndarray,
    obs_point: np.ndarray,
    obs_pixel: np.ndarray,  # (O, 2) raw pixels
    fixed_pose_mask: np.ndarray | None = None,
    fixed_point_mask: np.ndarray | None = None,
    scale: float = 0.01,
    block_points: int | None = None,
    max_slots: int = 32,
    max_window: int = 2048,
    pad_blocks_to: int = 1,
    layout: str = "host",
    device: torch.device | str | None = None,
):
    """Direct arrays -> point-major problem on `device` (CUDA unless the
    caller asks for another device; raises when none is given and no CUDA
    card is present).

    The layout is built on the host (`layout="host"`, the vectorized numpy
    builder) and copied to the device. The JAX package's device-side build
    (`layout="device"`) is not ported yet.

    Returns (problem, shape, pm, pshape), or None when the problem exceeds
    the layout's static bounds. `problem` is a FinalizedProblem whose
    observation-table columns and points are EMPTY (0-length): the PM
    engine reads only rig / R_cw / t_cw / opt indices from it.
    """
    if layout != "host":
        raise NotImplementedError(
            f"layout={layout!r}: only the host layout build is ported; the "
            "device build and PMLayoutCache come in a later slice"
        )
    device = resolve_device(device)
    cameras = list(cameras)
    N = poses_world_to_camera.shape[0]
    M = points.shape[0]
    if block_points is None:
        # 1024 landmarks per kernel block on large problems, 256 below
        # (less padding waste on small problems), as in the JAX package.
        block_points = 1024 if M >= 100_000 else 256
    if fixed_pose_mask is None:
        fixed_pose_mask = np.zeros(N, dtype=bool)
    if fixed_point_mask is None:
        fixed_point_mask = np.zeros(M, dtype=bool)
    fixed_point_mask = np.asarray(fixed_point_mask, bool)
    n_opt = int((~fixed_pose_mask).sum())
    m_opt = int((~fixed_point_mask).sum())
    pose_opt_of = np.full(N, n_opt, dtype=np.int32)
    pose_opt_of[~fixed_pose_mask] = np.arange(n_opt, dtype=np.int32)

    R_wc = poses_world_to_camera[:, :3, :3]
    t_wc = poses_world_to_camera[:, :3, 3]
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, t_wc) * scale

    res = build_point_major(
        np.asarray(obs_pose, np.int32),
        np.asarray(obs_point, np.int32),
        np.asarray(obs_cam, np.int32),
        np.asarray(obs_pixel, np.float64) * scale,
        np.asarray(points, np.float64) * scale,
        pose_opt_of,
        ~fixed_point_mask,
        len(cameras),
        scale,
        num_opt_poses=n_opt,
        block_points=block_points,
        max_slots=max_slots,
        max_window=max_window,
        pad_blocks_to=pad_blocks_to,
        device=device,
    )
    if res is None:
        return None
    pm, pshape = res

    f32 = dict(dtype=torch.float32, device=device)
    empty_i = torch.zeros((0,), dtype=torch.int32, device=device)
    problem = FinalizedProblem(
        rig=CameraRig.from_cameras(cameras, scale=scale, device=device),
        R_cw=torch.as_tensor(R_cw, **f32),
        t_cw=torch.as_tensor(t_cw, **f32),
        points=torch.zeros((0, 3), **f32),
        obs_cam=empty_i,
        obs_pose=empty_i,
        obs_point=empty_i,
        obs_pixel=torch.zeros((0, 2), **f32),
        obs_pose_opt=empty_i,
        obs_point_opt=empty_i,
        obs_valid=torch.zeros((0,), dtype=torch.bool, device=device),
        opt_pose_idx=torch.as_tensor(
            np.nonzero(~fixed_pose_mask)[0], dtype=torch.int64, device=device
        ),
        opt_point_idx=torch.as_tensor(
            np.nonzero(~fixed_point_mask)[0], dtype=torch.int64, device=device
        ),
    )
    shape = ProblemShape(
        num_poses=N,
        num_points=M,
        num_observations=int(np.asarray(obs_pose).shape[0]),
        num_opt_poses=n_opt,
        num_opt_points=m_opt,
        num_cameras=len(cameras),
        scale=scale,
    )
    return problem, shape, pm, pshape


def gather_opt_rows(tbl, opt_pose_idx, shape: PMShape):
    """The optimizable poses' (n_opt, 16) table rows: a slice when the opt
    range is contiguous (PMShape.opt_start), a gather otherwise -- identical
    values either way."""
    s = shape.opt_start
    if s is not None:
        return tbl[s : s + shape.num_opt_poses]
    return tbl[opt_pose_idx]


def scatter_opt_rows(tbl, rows, opt_pose_idx, shape: PMShape):
    """A new pose table with the opt-pose rows replaced (a slice write when
    the opt range is contiguous, an indexed write otherwise)."""
    out = tbl.clone()
    s = shape.opt_start
    if s is not None:
        out[s : s + shape.num_opt_poses] = rows
    else:
        out[opt_pose_idx] = rows
    return out


def retract_opt_rows(tbl, x, opt_pose_idx, shape: PMShape):
    """Candidate pose table: rows[opt] <- exp(x) * rows[opt], entirely in
    flat table form (cf. the reference's per-pose update at
    core/full_bundle_adjustment_solver.cpp:955-1000)."""
    dR, dt = se3_exp(x)
    opt_rows = gather_opt_rows(tbl, opt_pose_idx, shape)
    R9n, t3n = compose_flat(dR, dt, opt_rows[:, :9], opt_rows[:, 9:12])
    rows = torch.cat(
        [R9n, t3n, torch.zeros((x.shape[0], 4), dtype=tbl.dtype,
                               device=tbl.device)],
        dim=1,
    )
    return scatter_opt_rows(tbl, rows, opt_pose_idx, shape)


def _apply_cinv(Cb, t):
    """y = Cinv (b - t) on the point-major planes; Cb rows 9:15 hold Cinv,
    6:9 hold b. t: (4, Mp). Returns (3, Mp)."""
    ci = [Cb[9 + n] for n in range(6)]
    r0 = Cb[6] - t[0]
    r1 = Cb[7] - t[1]
    r2 = Cb[8] - t[2]
    y0 = ci[0] * r0 + ci[1] * r1 + ci[2] * r2
    y1 = ci[1] * r0 + ci[3] * r1 + ci[4] * r2
    y2 = ci[2] * r0 + ci[4] * r1 + ci[5] * r2
    return torch.stack([y0, y1, y2])


def _c_times(Cb, y):
    """C @ y on the planes (C damped, rows 0:6). y: (3, Mp) -> (3, Mp)."""
    c = [Cb[n] for n in range(6)]
    return torch.stack(
        [
            c[0] * y[0] + c[1] * y[1] + c[2] * y[2],
            c[1] * y[0] + c[3] * y[1] + c[4] * y[2],
            c[2] * y[0] + c[4] * y[1] + c[5] * y[2],
        ]
    )


def unfused_pcg(padded_points, Atri, rhs, precond_tri, max_iter, tol,
                corr_fn, x0=None):
    """Unfused PCG on the reduced system; the pose blocks stay in the flat
    tri layout (ops/sym6.py).

    `corr_fn(x (n_opt, 6)) -> (corr (n_opt, 6), t (4, padded_points))` is
    the landmark-side B Cinv B^T correction. `tol` is a 0-dim tensor (the
    forcing tolerance on ||r||^2 / ||rhs||^2). `x0` warm-starts the
    iteration (one extra matvec for the initial residual).

    Returns (x, t_at_x, iters) where t_at_x = B^T x accumulated alongside
    (exact at the returned x, needed by back-substitution)."""

    def matvec(x):
        corr, t = corr_fn(x)
        return tri6_matvec(Atri, x) - corr, t

    if x0 is None:
        x = torch.zeros_like(rhs)
        r = rhs
        t_acc = torch.zeros((4, padded_points), dtype=torch.float32,
                            device=rhs.device)
    else:
        Sx0, t_acc = matvec(x0)
        x = x0
        r = rhs - Sx0
    z = tri6_matvec(precond_tri, r)
    p = z
    rz = torch.sum(r * z)
    rhs_sq = torch.clamp_min(torch.sum(rhs * rhs), 1e-30)

    it = 0
    # One host read per CG iteration: the JAX while_loop condition.
    while it < max_iter and bool((torch.sum(r * r) > tol * rhs_sq).item()):
        Sp, tp = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Sp), 1e-30)
        x = x + alpha * p
        # t = B^T x is linear in x: accumulate alongside so no extra matvec
        # is needed for the back-substitution at the final x.
        t_acc = t_acc + alpha * tp
        r = r - alpha * Sp
        z = tri6_matvec(precond_tri, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, t_acc, it


def fused_pcg_planes(n_opt, padded_points, Atri, rhs, precond_tri, max_iter,
                     tol, corr_fn, x0=None):
    """PCG with the pose-side algebra of each iteration in one kernel
    (ops/cuda/cg_step.py), state in plane form (components x lane-padded
    poses). Same math as `unfused_pcg` up to float32 reduction order."""
    Np = padded_poses(n_opt)
    dev = rhs.device
    AP = torch.zeros((42, Np), dtype=torch.float32, device=dev)
    AP[:21, :n_opt] = Atri.T
    AP[21:, :n_opt] = precond_tri.T
    rhs_pl = to_planes(rhs, Np)
    rhs_sq = torch.clamp_min(torch.sum(rhs_pl * rhs_pl), 1e-30)

    def corr_planes(x_pl):
        corr, t = corr_fn(x_pl[:, :n_opt].T)
        return to_planes(corr, Np), t

    if x0 is None:
        x = torch.zeros((6, Np), dtype=torch.float32, device=dev)
        r = rhs_pl
        t_acc = torch.zeros((4, padded_points), dtype=torch.float32,
                            device=dev)
    else:
        x = to_planes(x0, Np)
        corr0, t_acc = corr_planes(x)
        r = rhs_pl - (plane_sym6_matvec(AP[:21], x) - corr0)
    p = plane_sym6_matvec(AP[21:], r)
    rz = torch.sum(r * p)
    rr = torch.sum(r * r)

    it = 0
    # One host read per CG iteration: the JAX while_loop condition.
    while it < max_iter and bool((rr > tol * rhs_sq).item()):
        corr_pl, tp = corr_planes(p)
        x, r, p, alpha, rz, rr = cg_pose_step(AP, corr_pl, x, r, p, rz)
        t_acc = t_acc + alpha * tp
        it += 1
    return x[:, :n_opt].T, t_acc, it


def _check_options(options: Options) -> None:
    """Raise for the options whose code paths a later slice ports."""
    if getattr(options, "coupling_dtype", "float32") != "float32":
        raise NotImplementedError(
            "coupling_dtype='bfloat16' is not ported yet (the bf16-U branch "
            "of the assembly and matvec kernels)"
        )
    if getattr(options, "cg_precond", "jacobi") == "schur_jacobi":
        raise NotImplementedError(
            "cg_precond='schur_jacobi' is not ported yet (the emit_schur "
            "branch of the assembly kernel)"
        )
    if options.time_iterations == "device":
        raise NotImplementedError(
            "time_iterations='device' is not ported yet (device-clock "
            "iteration times need the profiling tooling slice)"
        )


def _pm_loop_pieces(pm: PointMajorProblem, shape: PMShape, rig,
                    opt_pose_idx, options: Options):
    """(body, eval_cost) of the point-major LM loop. `options.pallas` names
    the JAX package's TPU-kernel switch and is ignored here."""
    opts = options
    dev = pm.X.device
    max_iter = opts.iteration_handle.max_num_iterations
    huber = opts.outlier_handle.threshold_huber_loss * shape.scale
    thr_step = opts.convergence_handle.threshold_step_size
    thr_cost = opts.convergence_handle.threshold_cost_change
    tr = opts.trust_region_handle
    inv_scale = 1.0 / shape.scale
    metric = getattr(opts, "cost_metric", "reference")
    n_obs = shape.num_observations
    is_lm = opts.solver_type == SolverType.LEVENBERG_MARQUARDT
    is_gd = opts.solver_type == SolverType.GRADIENT_DESCENT
    n_params = shape.num_opt_poses + torch.sum(pm.X[3])  # opt poses + landmarks
    warm = getattr(opts, "cg_warm_start", False)
    use_fused = opts.cg_fused_step and shape.num_opt_poses <= MAX_FUSED_POSES
    # Device fills, not host-to-device copies (a copy would synchronise).
    scalar = lambda v: torch.full((), v, dtype=torch.float32, device=dev)

    def eval_cost(tbl, X):
        s_norm, s_wsq, _, _ = K.cost_pm_tbl(pm, shape, tbl, X, rig, huber)
        return s_wsq if metric == "squared" else s_norm

    def corr_fn(Cb, U):
        return lambda x: K.matvec_corr_pm(pm, shape, Cb, U, x)

    def body(c: _Carry) -> _Carry:
        lam_eff = c.lam if is_lm else scalar(_GN_LAMBDA)
        flat, Cb, U = K.assemble_pm_tbl(pm, shape, c.tbl, c.X, rig, lam_eff,
                                        huber)
        Atri, a, rhs = K.finish_pose_system_tri(flat, lam_eff)

        if is_gd:
            def clip_blocks(g, clip):
                norms = torch.linalg.norm(g, dim=0, keepdim=True)
                return g * torch.clamp_max(
                    clip / torch.clamp_min(norms, 1e-30), 1.0
                )

            x = clip_blocks(a.T, opts.gd_step_clip).T  # (n_opt, 6)
            y = clip_blocks(Cb[6:9], opts.gd_step_clip)  # (3, Mp)
            cg_it = 0
            eta = scalar(0.0)
            rhs_norm = scalar(0.0)
        else:
            # rhs = a - B Cinv b arrives fused from the assembly kernel.
            precond_tri = inverse_tri6(Atri)
            tol, eta, rhs_norm = _cg_tolerance(
                opts, rhs, c.rhs_norm_prev, c.eta_prev
            )
            x0 = c.x_prev if warm else None
            if use_fused:
                x, t, cg_it = fused_pcg_planes(
                    shape.num_opt_poses, shape.padded_points, Atri, rhs,
                    precond_tri, opts.cg_max_iterations, tol, corr_fn(Cb, U),
                    x0=x0,
                )
            else:
                x, t, cg_it = unfused_pcg(
                    shape.padded_points, Atri, rhs, precond_tri,
                    opts.cg_max_iterations, tol, corr_fn(Cb, U), x0=x0,
                )
            y = _apply_cinv(Cb, t)  # (3, Mp)

        # Candidate update: T_cw <- exp(x) T_cw, X += y.
        tbl_cand = retract_opt_rows(c.tbl, x, opt_pose_idx, shape)
        X_cand = c.X.clone()
        X_cand[:3] += y * c.X[3:4]

        current_cost = eval_cost(tbl_cand, X_cand)
        # NaN/inf guard: reject non-finite candidates without poisoning
        # prev_cost.
        cost_ok = torch.isfinite(current_cost)

        if is_lm:
            # Quadratic-model decrease without an extra observation pass:
            # B^T x = b - C y identically from the back-substitution.
            term_pose = torch.sum(a * x) + torch.sum(x * tri6_matvec(Atri, x))
            b_pl = Cb[6:9]
            Cy = _c_times(Cb, y)
            term_point = torch.sum(b_pl * y) + torch.sum(y * Cy)
            cross = 2.0 * torch.sum(y * (b_pl - Cy))
            model_decrease = -(term_pose + term_point + cross)
            rho = (current_cost - c.prev_cost) * inv_scale / model_decrease
            accept = (rho > tr.threshold_update) & cost_ok
            trust_more = (rho > tr.threshold_trust_more) & cost_ok
            lam_new = torch.where(
                trust_more,
                torch.clamp_min(c.lam * tr.decrease_ratio_lambda,
                                tr.min_lambda),
                torch.where(
                    rho <= tr.threshold_update,
                    torch.clamp_max(c.lam * tr.increase_ratio_lambda,
                                    tr.max_lambda),
                    c.lam,
                ),
            )
            status = torch.where(
                trust_more,
                scalar(float(int(IterationStatus.UPDATE_TRUST_MORE))),
                torch.where(
                    accept,
                    scalar(float(int(IterationStatus.UPDATE))),
                    scalar(float(int(IterationStatus.SKIPPED))),
                ),
            )
        else:
            accept = cost_ok
            lam_new = c.lam
            status = scalar(float(int(IterationStatus.UPDATE)))

        tbl_next = torch.where(accept, tbl_cand, c.tbl)
        X_next = torch.where(accept, X_cand, c.X)

        cost_change = torch.abs(current_cost - c.prev_cost)
        step_pose = torch.sum(torch.linalg.norm(x, dim=-1))
        step_point = torch.sum(
            torch.sqrt(torch.clamp_min(torch.sum(y * y, dim=0), 0.0))
            * c.X[3]
        )
        avg_step = (step_pose + step_point) / n_params
        conv_now = (avg_step < thr_step) | (cost_change < thr_cost)
        at_last = c.it >= max_iter - 1
        converged = torch.zeros_like(conv_now) if at_last else conv_now

        skipped = ~accept
        row = torch.zeros((INFO_NUM_COLS,), dtype=torch.float32, device=dev)
        row[INFO_COST] = torch.where(skipped, c.prev_cost, current_cost)
        row[INFO_COST_CHANGE] = torch.where(
            skipped, scalar(0.0), cost_change
        )
        row[INFO_AVG_REPROJ] = torch.where(
            skipped, torch.sqrt(c.prev_cost / n_obs), current_cost / n_obs
        )
        row[INFO_ABS_STEP] = avg_step
        row[INFO_ABS_GRADIENT] = 0.0
        row[INFO_DAMPING] = lam_new
        row[INFO_STATUS] = status
        row[INFO_CG_ITERS] = float(cg_it)
        c.info[c.it] = row  # in place: the previous carry is not kept

        return _Carry(
            tbl=tbl_next,
            X=X_next,
            lam=lam_new,
            prev_cost=torch.where(cost_ok, current_cost, c.prev_cost),
            it=c.it + 1,
            done=conv_now | at_last,
            converged=converged,
            info=c.info,
            num_info=c.num_info + 1,
            x_prev=x,
            rhs_norm_prev=rhs_norm,
            eta_prev=eta,
        )

    return body, eval_cost


def _init_carry(pm, shape: PMShape, rig, R_cw0, t_cw0, options: Options,
                eval_cost) -> _Carry:
    dev = pm.X.device
    tbl0 = K.pose_table(R_cw0, t_cw0, shape.window)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return _Carry(
        tbl=tbl0,
        X=pm.X,
        lam=torch.full((), options.trust_region_handle.initial_lambda,
                       dtype=torch.float32, device=dev),
        prev_cost=eval_cost(tbl0, pm.X),
        it=0,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        info=torch.zeros(
            (options.iteration_handle.max_num_iterations, INFO_NUM_COLS),
            dtype=torch.float32, device=dev,
        ),
        num_info=0,
        x_prev=torch.zeros((shape.num_opt_poses, 6), dtype=torch.float32,
                           device=dev),
        rhs_norm_prev=zero,
        eta_prev=zero,
    )


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_pm(
    problem: FinalizedProblem,
    shape: ProblemShape,
    options: Options,
    pm_and_shape: tuple[PointMajorProblem, PMShape],
) -> tuple[FullBAState, Summary]:
    """Solve on the point-major engine, on the device the problem's tensors
    live on (from `pm_problem_from_arrays`). Returns (FullBAState, Summary)
    like the JAX package's `solve_pm`.

    `options.time_iterations=True` wall-clocks each LM iteration, ending
    each in a device synchronize."""
    _check_options(options)
    pm, pshape = pm_and_shape
    dev = pm.X.device
    rig = problem.rig
    max_iter = options.iteration_handle.max_num_iterations
    timed = bool(options.time_iterations)

    t0 = time.perf_counter()
    body, eval_cost = _pm_loop_pieces(
        pm, pshape, rig, problem.opt_pose_idx, options
    )
    carry = _init_carry(pm, pshape, rig, problem.R_cw, problem.t_cw, options,
                        eval_cost)
    iter_times_ms = [] if timed else None
    # One host read per LM iteration: the JAX while_loop condition.
    while carry.it < max_iter and not bool(carry.done.item()):
        t_it = time.perf_counter()
        carry = body(carry)
        if timed:
            _synchronize(dev)
            iter_times_ms.append((time.perf_counter() - t_it) * 1e3)

    huber = options.outlier_handle.threshold_huber_loss * pshape.scale
    inv_scale = 1.0 / pshape.scale
    _, _, s_sq, s_cnt = K.cost_pm_tbl(pm, pshape, carry.tbl, carry.X, rig,
                                      huber)
    rmse_px = torch.sqrt(s_sq / torch.clamp_min(s_cnt, 1.0)) * inv_scale
    _synchronize(dev)
    total_ms = (time.perf_counter() - t0) * 1e3

    N = pshape.num_poses
    R_cw = carry.tbl[:N, :9].reshape(N, 3, 3)
    t_user = carry.tbl[:N, 9:12] * inv_scale
    R_wc, t_wc = inverse_se3(R_cw, t_user)
    T = torch.zeros((N, 4, 4), dtype=torch.float32, device=dev)
    T[:, :3, :3] = R_wc
    T[:, :3, 3] = t_wc
    T[:, 3, 3] = 1.0

    # Un-permute landmarks back to their original rows.
    ref = pm.point_ref.to(torch.int64)
    live = ref >= 0
    points = torch.zeros((shape.num_points, 3), dtype=torch.float32,
                         device=dev)
    points[ref[live]] = carry.X[:3, live].T
    points = points * inv_scale

    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    state = FullBAState(
        poses_world_to_camera=T,
        points=points,
        converged=carry.converged,
        num_iterations=as_i32(carry.it),
        info=carry.info,
        num_info=as_i32(carry.num_info),
        final_cost=carry.prev_cost,
        final_rmse_px=rmse_px,
    )
    summary = Summary.from_device_buffers(
        info=carry.info.cpu().numpy(),
        num_iterations=carry.num_info,
        converged=bool(carry.converged.item()),
        max_iteration=max_iter,
        threshold_step_size=options.convergence_handle.threshold_step_size,
        threshold_cost_change=options.convergence_handle.threshold_cost_change,
        total_time_ms=total_ms,
        iter_times_ms=np.asarray(iter_times_ms) if timed else None,
        final_rmse_px=float(rmse_px.item()),
    )
    return state, summary
