#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card (an H100: the kernels are
built for sm_90a). It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the package's CUDA kernels from csrc/ with nvcc, all sources at
     once, and prints the build time and what ptxas reports;
  3. builds the flagship problem: the corridor stereo problem of 10,000
     poses and 1,000,000 landmarks (window 6, seed 123, 2 fixed poses,
     12,000,000 observations), laid out point-major on the card;
  4. holds every kernel against its plain PyTorch version on the card at
     the shapes the flagship solve gives it, element by element; times
     both with CUDA events (20 calls queued back to back, L2 evicted
     before each, after warm-up) and one call from an idle card; and
     computes each kernel's bound;
  5. sets every launch count to 0 and solves the flagship problem through
     the public entry points (LM, Eisenstat-Walker forcing, CG cap 25, fused
     CG step) with 30 forced LM iterations; then reads the counts;
  6. prints one JSON line of per-kernel figures and, last, one JSON line
     naming the device.

It exits non-zero, before printing any result, when no CUDA card is
present, when the package is missing, when a kernel does not build or
launch, disagrees with its plain version beyond its tolerance, or was not
launched by the solve, when a plain version ran during the solve, or when
the solve misses 0.01 px within 30 LM iterations.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

NUM_POSES, NUM_POINTS, WINDOW, SEED = 10_000, 1_000_000, 6, 123
TARGET_RMSE_PX = 0.01
LM_ITERATIONS = 30
TIMING_REPS = 20

# Published H100 SXM figures (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores. A bound is the larger of bytes over
# the first and operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Tolerances. Element by element, a kernel's output may differ from its plain
# version's by rtol times the plain value (the CG step: times its float32
# rounding scale) plus atol_frac times the largest magnitude in the output
# row (each plane row, panel column or scalar); why they differ at all. The
# atol term covers small elements that are sums of signed terms, whose
# rounding is relative to the terms, not to the element. Each limit sits
# 2-4x (the cost's and the CG step's about 12-17x) above what the kernels
# read on an H100 at the flagship; the per-output lines print those
# readings.
TOLERANCE = {
    "assemble": (1e-4, 1e-5, "FMA contraction; point block summed slot-major, "
                             "not camera-major; the 3x3 inverse amplifies "
                             "that by C's condition number; atomics reorder "
                             "the panel sums"),
    "matvec": (2e-5, 2e-6, "FMA contraction; atomics reorder the panel sums"),
    "cost": (1e-6, 0.0, "block reductions in another order"),
    "cg_step": (1e-6, 0.0, "block reductions in another order; r' = r - "
                           "alpha Sp cancels, so each output is held to its "
                           "float32 rounding scale"),
}


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _compare(got, want, rtol, atol_frac, scale=None) -> dict:
    """Element-wise comparison; rows are the first axis. `ratio` is the
    largest error over what the element may differ by: rtol times `scale`
    (default |want|) plus atol_frac times the largest |want| of its row. It
    passes at 1 or less. `row` is the largest error over its row's largest
    |want|, and `elem_f` the largest error relative to |want| over the
    elements with |want| at least f of their row's largest."""
    import torch

    def rows(t):
        t = t.double()
        return t.reshape(t.shape[0], -1) if t.dim() else t.reshape(1, 1)

    g, w = rows(got), rows(want)
    s = w.abs() if scale is None else rows(scale).abs()
    if not bool(torch.isfinite(g).all()):
        return {"abs": float("inf"), "ratio": float("inf"), "row": float("inf")}
    d = (g - w).abs()
    top = w.abs().amax(dim=1, keepdim=True)
    allowed = rtol * s + atol_frac * top

    def worst(num, den):
        q = torch.where(den > 0, num / den.clamp_min(1e-300),
                        torch.where(num > 0, torch.inf, 0.0))
        return float(q.max())

    out = {"abs": float(d.max()), "ratio": worst(d, allowed),
           "row": worst(d.amax(dim=1, keepdim=True), top)}
    for f in (1e-1, 1e-3, 1e-5):
        big = w.abs() >= f * top
        out[f"elem_{f:.0e}"] = worst(torch.where(big, d, 0.0), w.abs())
    return out


_CYCLES_PER_MS = None


def _device_ms(fn, reps=TIMING_REPS) -> tuple[float, bool]:
    """Device time of one call of `fn`: `reps` calls queued back to back
    behind a spin kernel, each between its own pair of CUDA events, so the
    host work of each call (checks, allocation, the launch) overlaps the
    card's work instead of standing between the events. Before each call a
    256 MB fill evicts the 50 MB L2, as the solve's other kernels do between
    two calls of one kernel. Returns (median ms per call, whether every call
    was queued before the card reached the first); the second is False when
    `fn` synchronises or the host fell behind."""
    import torch

    global _CYCLES_PER_MS
    ev = lambda: torch.cuda.Event(enable_timing=True)
    if _CYCLES_PER_MS is None:
        a, b = ev(), ev()
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS = 10_000_000 / a.elapsed_time(b)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        flush.zero_()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    marks = [(ev(), ev()) for _ in range(reps)]
    torch.cuda._sleep(int(_CYCLES_PER_MS * (2 * host_ms + 5)))
    first = ev()
    first.record()
    for a, b in marks:
        flush.zero_()
        a.record()
        fn()
        b.record()
    ahead = not first.query()
    marks[-1][1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks), ahead


def _call_ms(fn) -> float:
    """Median time of one call from an idle card, the wrapper's host work
    included: what a caller that waits on each call sees."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: int, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from bundle_adjustment_solver_tpu_torch import (
            Options, corridor_ba_problem, pm_problem_from_arrays, solve_pm)
        from bundle_adjustment_solver_tpu_torch.ops.cuda import _build
        from bundle_adjustment_solver_tpu_torch.ops.cuda import cg_step as CG
        from bundle_adjustment_solver_tpu_torch.ops.cuda import full_ba_pm as K
        from bundle_adjustment_solver_tpu_torch.ops.sym6 import inverse_tri6
        from bundle_adjustment_solver_tpu_torch.options import (
            ConvergenceHandle, IterationHandle, SolverType)
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        print("chip_smoke: TF32 matmuls are enabled; the port runs in full "
              "float32", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    device_line = _device_line()
    print(device_line, flush=True)

    # -- build -------------------------------------------------------------
    build_s = _build.build()
    print(f"kernel build: {build_s:.1f} s ({', '.join(_build.SOURCES)})",
          flush=True)
    for name, log in _build.PTXAS_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- flagship problem ----------------------------------------------------
    t0 = time.perf_counter()
    prob = corridor_ba_problem(NUM_POSES, NUM_POINTS, window=WINDOW,
                               seed=SEED)
    gen_s = time.perf_counter() - t0
    fixed = np.zeros(NUM_POSES, dtype=bool)
    fixed[prob.fixed_pose_ids] = True
    t0 = time.perf_counter()
    built = pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel,
        fixed_pose_mask=fixed, device=dev,
    )
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    problem, shape, pm, ps = built
    print(f"problem: {shape.num_observations} observations, generated in "
          f"{gen_s:.1f} s, laid out in {layout_s:.1f} s; Kp={ps.slots} "
          f"C={ps.cams} bm={ps.block_points} P={ps.window} "
          f"Mp={ps.padded_points} blocks={ps.num_blocks} "
          f"n_opt={ps.num_opt_poses}", flush=True)

    # -- kernels against their plain versions ---------------------------------
    opts0 = Options()
    lam = opts0.trust_region_handle.initial_lambda
    huber = opts0.outlier_handle.threshold_huber_loss * ps.scale
    pose_tbl = K.pose_table(problem.R_cw, problem.t_cw, ps.window)
    cam_tbl = K._cam_table(problem.rig)
    scal = K._scalars(lam, huber, dev)
    Kp, C, Mp, nb, P = (ps.slots, ps.cams, ps.padded_points, ps.num_blocks,
                        ps.window)
    valid = pm.obs_f32[2 * Kp * C:]
    n_cells = float(valid.sum())  # valid (slot, camera) cells
    n_slots = float((pm.slot_opt >= 0).sum())  # slots that scatter
    kernels = []
    failures = []

    def record(name, source, replaces, errs, fns, nbytes, ops):
        """Check `errs` (output name -> _compare result) against the
        kernel's tolerance, time the kernel and its plain version, and add
        the kernel's entry to the kernels line."""
        rtol, atol_frac, why = TOLERANCE[name]
        abs_err = max(e["abs"] for e in errs.values())
        ratio = max(e["ratio"] for e in errs.values())
        ms, ahead = _device_ms(fns[0])
        plain_ms, _ = _device_ms(fns[1])
        call_ms = _call_ms(fns[0])
        bound_ms, bound_by = _bound(nbytes, ops)
        ok = ratio <= 1.0
        print(f"kernel {name}: max_abs_err={abs_err:.3e}, error/allowed="
              f"{ratio:.3e} (rtol {rtol:.0e}, atol {atol_frac:.0e} of the "
              f"row's largest: {why}) {'ok' if ok else 'MISS'}; ms={ms:.4f} "
              f"(queued ahead: {ahead}) call_ms={call_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
              flush=True)
        for out, e in errs.items():
            print(f"  {name}.{out}: " + " ".join(
                f"{k}={v:.2e}" for k, v in e.items()), flush=True)
        if not ok:
            failures.append(f"{name} disagrees with its plain version: "
                            f"error {ratio:.3e} times what is allowed")
        if not ahead:
            failures.append(f"{name}: the host did not keep ahead of the "
                            f"card, so ms is not the kernel's time")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ))

    def compare(name, got, want, scale=None):
        rtol, atol_frac, _ = TOLERANCE[name]
        return _compare(got, want, rtol, atol_frac, scale)

    src_pm = "bundle_adjustment_solver_tpu_torch/csrc/full_ba_pm.cu"
    src_cg = "bundle_adjustment_solver_tpu_torch/csrc/cg_step.cu"
    jax_pm = "bundle_adjustment_solver_tpu/ops/pallas/full_ba_pm.py"
    cols = lambda pan: pan.permute(2, 0, 1)  # one row per panel column

    # Assembly.
    args = (pm, ps, pose_tbl, pm.X, cam_tbl, scal)
    U, Cb, pan = K.assemble_pm_blocks(*args)
    U_p, Cb_p, pan_p = K.assemble_pm_blocks_plain(*args)
    torch.cuda.synchronize()
    errs = {"U": compare("assemble", U, U_p),
            "Cb": compare("assemble", Cb, Cb_p),
            "panels": compare("assemble", cols(pan), cols(pan_p))}
    del U_p, Cb_p, pan_p
    # Operations: ~350 per valid (slot, camera) cell (warp, projection,
    # Jacobians, C, b, U, A, a), ~70 per scattering slot (U mask, B Cinv b).
    record("assemble", src_pm, f"{jax_pm}:452", errs,
           (lambda: K.assemble_pm_blocks(*args),
            lambda: K.assemble_pm_blocks_plain(*args)),
           _nbytes(pose_tbl, cam_tbl, scal, pm.obs_f32, pm.slot_pose,
                   pm.slot_opt, pm.X, pm.gbase, pm.sbase, U, Cb, pan),
           350 * n_cells + 70 * n_slots)

    # Matvec at a seeded pose vector.
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((ps.num_opt_poses, 6), generator=gen).to(dev)
    x_tbl = torch.zeros((ps.num_opt_poses + P, K.X_COLS), device=dev)
    x_tbl[:ps.num_opt_poses, :6] = x
    margs = (pm, ps, Cb, U, x_tbl, "matvec")
    pan_k, t_k = K.matvec_pm_blocks(*margs)
    pan_q, t_q = K.matvec_pm_blocks_plain(*margs)
    rpan_k, _ = K.matvec_pm_blocks(pm, ps, Cb, U, x_tbl, "rhs")
    rpan_q, _ = K.matvec_pm_blocks_plain(pm, ps, Cb, U, x_tbl, "rhs")
    errs = {"panels": compare("matvec", cols(pan_k), cols(pan_q)),
            "t": compare("matvec", t_k, t_q),
            "rhs_panels": compare("matvec", cols(rpan_k), cols(rpan_q))}
    # Bytes: U once, the 6 Cinv rows of Cb, slot_opt, the x window table,
    # t and the panels out. Operations: ~72 per scattering slot.
    record("matvec", src_pm, f"{jax_pm}:610", errs,
           (lambda: K.matvec_pm_blocks(*margs),
            lambda: K.matvec_pm_blocks_plain(*margs)),
           _nbytes(U, Cb[9:15], pm.slot_opt, pm.sbase, x_tbl, t_k, pan_k),
           72 * n_slots + 15 * Mp)

    # Cost.
    cargs = (pm, ps, pose_tbl, pm.X, cam_tbl, scal)
    part_k = K.cost_pm_blocks(*cargs)
    part_q = K.cost_pm_blocks_plain(*cargs)
    errs = {"sums": compare("cost", part_k.sum(0), part_q.sum(0))}
    # Bytes: obs, slot_pose, X rows 0:3 in; partials out. Operations: ~60
    # per valid (slot, camera) cell.
    record("cost", src_pm, f"{jax_pm}:705", errs,
           (lambda: K.cost_pm_blocks(*cargs),
            lambda: K.cost_pm_blocks_plain(*cargs)),
           _nbytes(pose_tbl, cam_tbl, pm.obs_f32, pm.slot_pose, pm.X[:3],
                   pm.gbase, part_k),
           60 * n_cells)

    # CG step on the first PCG iteration of the flagship's first system.
    flat = K._second_level(pan, pm.sbase, ps.num_opt_poses, P, K.A_COLS)
    Atri, _, rhs = K.finish_pose_system_tri(flat, lam)
    n_opt = ps.num_opt_poses
    Np = CG.padded_poses(n_opt)
    AP = torch.zeros((42, Np), device=dev)
    AP[:21, :n_opt] = Atri.T
    AP[21:, :n_opt] = inverse_tri6(Atri).T
    r = CG.to_planes(rhs, Np)
    p = CG.plane_sym6_matvec(AP[21:], r)
    rz = torch.sum(r * p)
    corr, _ = K.matvec_corr_pm(pm, ps, Cb, U, p[:, :n_opt].T)
    sargs = (AP, CG.to_planes(corr, Np), torch.zeros_like(r), r, p, rz)
    out_k = CG.cg_pose_step(*sargs)
    out_q = CG.cg_pose_step_plain(*sargs)
    scales = CG.cg_pose_step_rounding_scale(
        *[t.double() for t in sargs], [t.double() for t in out_q])
    names = ("x", "r", "p", "alpha", "rz", "rr")
    errs = {k: compare("cg_step", g, w, s)
            for k, g, w, s in zip(names, out_k, out_q, scales)}
    print(f"  cg_step: r' is {float(scales[1].max() / out_q[1].abs().max()):.3e}"
          f" times smaller than its terms", flush=True)
    # The check must see a wrong r' or rr: zeroed, or doubled.
    for k, bad in (("r", torch.zeros_like(out_k[1])), ("rr", 2 * out_k[5])):
        i = names.index(k)
        seen = compare("cg_step", bad, out_q[i], scales[i])["ratio"]
        print(f"  cg_step: a planted wrong {k} reads error/allowed={seen:.3e}",
              flush=True)
        if seen <= 1.0:
            failures.append(f"cg_step's check passes a wrong {k}")
    # Bytes: AP, corr, x, r, p, rz in; x', r', p' and 3 scalars out.
    # Operations: ~200 per pose lane (two sym6 products, updates, dots).
    record("cg_step", src_cg,
           "bundle_adjustment_solver_tpu/ops/pallas/cg_step.py:91", errs,
           (lambda: CG.cg_pose_step(*sargs),
            lambda: CG.cg_pose_step_plain(*sargs)),
           _nbytes(*sargs, *out_k[:3]) + 12, 200 * Np)
    del U, Cb, pan, pan_k, t_k, pan_q, t_q, rpan_k, rpan_q, out_k, out_q
    torch.cuda.empty_cache()

    # -- the main path: the flagship solve ---------------------------------------
    counters = {
        "assemble": K.assemble_pm_blocks, "matvec": K.matvec_pm_blocks,
        "cost": K.cost_pm_blocks, "cg_step": CG.cg_pose_step,
    }
    plains = (K.assemble_pm_blocks_plain, K.matvec_pm_blocks_plain,
              K.cost_pm_blocks_plain, CG.cg_pose_step_plain)
    for fn in counters.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    options = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(LM_ITERATIONS),
        reduced_system="cg", cg_max_iterations=25, cg_tolerance=0.0,
        cg_forcing="ew", cg_fused_step=True,
    )
    t0 = time.perf_counter()
    state, summary = solve_pm(problem, shape, options, (pm, ps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    plain_calls = sum(fn.calls for fn in plains)
    rmse = summary.final_reprojection_rmse_px
    cg_total = int(sum(i.cg_iterations for i in summary.optimization_info_list))
    print(f"solve: {LM_ITERATIONS} LM iterations, {cg_total} CG iterations, "
          f"{wall:.3f} s wall, final RMSE {rmse:.5f} px", flush=True)
    print(f"launches during the solve: {launches}; plain-version calls: "
          f"{plain_calls}", flush=True)

    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            failures.append(f"kernel {k['name']} was not launched by the solve")
    if plain_calls:
        failures.append(f"plain versions ran {plain_calls} times in the solve")
    if rmse > TARGET_RMSE_PX:
        failures.append(f"final RMSE {rmse:.5f} px > {TARGET_RMSE_PX} after "
                        f"{LM_ITERATIONS} LM iterations")
    T, pts = state.poses_world_to_camera, state.points
    if tuple(T.shape) != (NUM_POSES, 4, 4) or tuple(pts.shape) != (
            NUM_POINTS, 3) or not bool(torch.isfinite(T).all()) or not bool(
            torch.isfinite(pts).all()):
        failures.append("solution has the wrong shape or non-finite values")
    else:
        pose_err = float((T[:, :3, 3].cpu().double() - torch.as_tensor(
            prob.poses_true[:, :3, 3])).abs().max())
        point_err = float((pts.cpu().double() - torch.as_tensor(
            prob.points_true)).abs().max())
        print(f"solution vs ground truth: max pose translation error "
              f"{pose_err:.3e} m, max point error {point_err:.3e} m")

    if failures:
        for msg in failures:
            print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
