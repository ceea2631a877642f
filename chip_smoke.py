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
  6. for each mode of the batched pose-only solvers (6-DoF mono and stereo,
     planar 3-DoF mono and stereo) at 2048 frames x 256 points, with the
     JAX package's benchmark seeds (bench.py: mono 13, stereo 11, planar
     17): holds the mode's stats kernel against its plain version on the
     card at the initial poses and at a seeded perturbed pose set, checks
     that planted faults (every frame's cost doubled, J^T W J (0, 0)
     zeroed) fail that check, and times kernel and plain version; sets
     every launch count to 0 and solves through the public entry point
     (convergence thresholds 1e-7, at most 40 iterations, no history),
     reading the counts just after; then runs 200 forced lockstep
     iterations and prints iterations/s, observations x iterations/s and
     the kernel's share of the wall;
  7. prints one JSON line of per-kernel figures and, last, one JSON line
     naming the device.

It exits non-zero, before printing any result, when no CUDA card is
present, when the package is missing, when a kernel does not build or
launch, disagrees with its plain version beyond its tolerance, passes a
planted fault, or was not launched by its solve, when a plain version ran
during a solve, when the flagship solve misses 0.01 px within 30 LM
iterations, or when a batched solve leaves a frame failed, unconverged or
further from the generator's truth than POSE_ERR_LIMIT.
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

# Batched pose-only phases: the JAX package's benchmark size and seeds
# (bench.py: bench_pose_only_batched_mono / _stereo / _planar).
BATCH_FRAMES, BATCH_POINTS = 2048, 256
BATCH_SEEDS = {"mono": 13, "stereo": 11, "planar_mono": 17,
               "planar_stereo": 17}
BATCH_MAX_ITERATIONS = 40
FORCED_ITERATIONS = 200
# Largest |pose - truth| entry a noise-free batched solve may end at: the
# four modes read 2.3e-7 to 3.6e-7 on an H100, 2.8-4.4x below this.
POSE_ERR_LIMIT = 1e-6

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
# The batched stats kernels are held element by element to rtol times each
# entry's rounding scale (pose_only_batched.gn_stats_rounding_scale: a bound
# on the sum of its terms' magnitudes), not to a fraction of the entry or of
# its stat's largest value over the frames: entries cancel, and with
# fx = fy the 6-DoF J^T W J (2, 5) is zero in exact arithmetic, so both
# sides hold only rounding there. The Huber weight huber / (|r_u| + |r_v|)
# takes the rounding of r = projection - pixel, which is relative to the
# pixel coordinates, not to r. The four kernels read 1.1e-5 to 6.4e-5 of
# the scale on an H100 (mono at the perturbed poses is the largest); 2e-4
# puts the limit 3.1x above the largest reading.
_BGN_WHY = ("FMA contraction; each frame's 256 products summed by warp "
            "shuffles instead of torch's reduction order; the weight rounds "
            "with the pixel coordinates")
for _name in ("bgn_mono", "bgn_stereo", "bgn_planar_mono",
              "bgn_planar_stereo"):
    TOLERANCE[_name] = (2e-4, 0.0, _BGN_WHY)

# Operations per point and camera of the batched stats kernels (warp,
# projection, weight, Jacobian, the stat products and sums), and of the
# right camera's chained warp.
BGN_OPS_6DOF, BGN_OPS_PLANAR, BGN_OPS_RIG = 190, 110, 18


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


_CYCLES_PER_MS = 0.0
# Shortest spin that holds the stream while the host queues the timed calls:
# it covers a host that is descheduled for a while (a shared machine's CPU
# quota can stall a process for tens of ms) on top of 4x the host time that
# the same calls took just before.
GATE_MIN_MS = 250.0


def _cycles_per_ms() -> float:
    """The card's spin rate in clock cycles per ms, read now from two spins
    back to back (the first lets the clock ramp up from idle), and kept as
    the highest reading so far: a reading taken while the clock ramps up is
    low, and a spin sized from it would end sooner than asked."""
    import torch

    global _CYCLES_PER_MS
    a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda._sleep(20_000_000)
    c.record()
    c.synchronize()
    fastest = min(a.elapsed_time(b), b.elapsed_time(c))
    _CYCLES_PER_MS = max(_CYCLES_PER_MS, 20_000_000 / fastest)
    return _CYCLES_PER_MS


def _device_ms(fn, reps=TIMING_REPS) -> tuple[float, bool, str]:
    """Device time of one call of `fn`: `reps` calls queued back to back
    behind a spin kernel, each between its own pair of CUDA events, so the
    host work of each call (checks, allocation, the launch) overlaps the
    card's work instead of standing between the events. Before each call a
    256 MB fill evicts the 50 MB L2, as the solve's other kernels do between
    two calls of one kernel. Returns the median ms per call; whether every
    call was queued before the card reached the first (False when `fn`
    synchronises or the host fell behind the spin); and how long the host
    took to queue them and the spin lasted, both in ms."""
    import torch

    ev = lambda: torch.cuda.Event(enable_timing=True)
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
    cycles = int(_cycles_per_ms() * (4 * host_ms + GATE_MIN_MS))
    spin, first = ev(), ev()
    spin.record()
    torch.cuda._sleep(cycles)
    first.record()
    t0 = time.perf_counter()
    for a, b in marks:
        flush.zero_()
        a.record()
        fn()
        b.record()
    queue_ms = (time.perf_counter() - t0) * 1e3
    ahead = not first.query()
    marks[-1][1].synchronize()
    gate = (f"queued in {queue_ms:.1f} ms behind a "
            f"{spin.elapsed_time(first):.1f} ms spin")
    return statistics.median(a.elapsed_time(b) for a, b in marks), ahead, gate


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


def _stat_rows(stats, n):
    """(B, NS) stats -> the three blocks J^T W J, J^T W r and cost, each
    one row per stat over the frames."""
    return {"JtWJ": stats[:, :n].T, "JtWr": stats[:, n:-1].T,
            "cost": stats[:, -1:].T}


def _batched_problem(mode, dev):
    """The mode's benchmark problem on the card: (tensors, truth, n_obs)."""
    import dataclasses

    import numpy as np
    from bundle_adjustment_solver_tpu_torch import (
        batched_planar_pose_only_problem, batched_stereo_pose_only_problem)
    from bundle_adjustment_solver_tpu_torch.convert import (
        batched_problem_tensors)

    B, P, seed = BATCH_FRAMES, BATCH_POINTS, BATCH_SEEDS[mode]
    if mode.startswith("planar"):
        prob = batched_planar_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=seed,
            stereo=mode == "planar_stereo")
        truth = prob.poses_world_to_current_true
    else:
        prob = batched_stereo_pose_only_problem(
            num_frames=B, points_per_frame=P, seed=seed)
        truth = prob.poses_true
    arrays = dataclasses.asdict(prob)
    arrays["valid"] = np.ones((B, P), bool)
    t = batched_problem_tensors(arrays, dev)
    # Observations as the JAX benchmark counts them: left points, plus the
    # matched right points in stereo.
    n_obs = B * P
    if mode.endswith("stereo"):
        n_obs += int((prob.pixels_right[..., 0] >= 0).sum())
    return t, truth, n_obs


def _small_rotations(rng, B, sigma):
    """(B, 3, 3) rotations about seeded axis-angle vectors (Rodrigues)."""
    import numpy as np

    w = rng.normal(0, sigma, (B, 3))
    th = np.linalg.norm(w, axis=1)[:, None, None]
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    K = (K - K.transpose(0, 2, 1)) / th  # cross-product matrix of the axis
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _perturbed_state(mode, t, truth):
    """A seeded pose set near the truth, in the form of the mode's solver
    state: (12, B) camera<-world pose rows, or (B, 3) planar theta."""
    import numpy as np
    import torch
    from bundle_adjustment_solver_tpu_torch.ops.cuda import (
        pose_only_batched as BK)

    rng = np.random.default_rng(7)
    B = truth.shape[0]
    f32 = dict(dtype=torch.float32, device=t["points"].device)
    if mode.startswith("planar"):
        theta = t["theta_true"].cpu().double().numpy()
        return torch.as_tensor(
            theta + rng.normal(0, [0.02, 0.02, 0.01], (B, 3)), **f32)
    T = np.linalg.inv(truth)
    T[:, :3, :3] = _small_rotations(rng, B, 0.01) @ T[:, :3, :3]
    T[:, :3, 3] += rng.normal(0, 0.01, (B, 3))
    return BK.pose_rows(torch.as_tensor(T[:, :3, :3], **f32),
                        torch.as_tensor(T[:, :3, 3], **f32))


def _batched_phase(mode, dev, kernels, failures, counted) -> None:
    """One batched pose-only mode: its kernel against the plain version,
    the solve through the public entry point, and the forced-iteration
    run. Adds the kernel's entry to `kernels` and what failed to
    `failures`; `counted` holds every wrapper and plain version, whose
    counts the solve starts from 0."""
    import numpy as np
    import torch
    import bundle_adjustment_solver_tpu_torch as port
    from bundle_adjustment_solver_tpu_torch.ops.cuda import (
        pose_only_batched as BK)
    from bundle_adjustment_solver_tpu_torch.options import (
        ConvergenceHandle, IterationHandle, Options, OutlierHandle)
    from bundle_adjustment_solver_tpu_torch.solvers import pose_only

    name = f"bgn_{mode}"
    planar, stereo = mode.startswith("planar"), mode.endswith("stereo")
    kernel, plain, line = {
        "mono": (BK.batched_mono_gn_stats,
                 BK.batched_mono_gn_stats_plain, 117),
        "stereo": (BK.batched_stereo_gn_stats,
                   BK.batched_stereo_gn_stats_plain, 128),
        "planar_mono": (BK.batched_planar_mono_gn_stats,
                        BK.batched_planar_mono_gn_stats_plain, 314),
        "planar_stereo": (BK.batched_planar_stereo_gn_stats,
                          BK.batched_planar_stereo_gn_stats_plain, 327),
    }[mode]
    rtol, atol_frac, why = TOLERANCE[name]
    huber = 1.0  # bench.py's OutlierHandle(1.0, 2.5)

    t, truth, n_obs = _batched_problem(mode, dev)
    # The kernel's arguments as the solver lays them out, at the solve's
    # initial poses and at a seeded set near the truth.
    frames = pose_only.batched_frames(mode, t, dev)
    sets = [pose_only.stats_args(frames, state, huber) for state in
            (frames.state0, _perturbed_state(mode, t, truth))]
    n = 6 if planar else 21
    B, P = BATCH_FRAMES, BATCH_POINTS

    # -- kernel against its plain version, two pose sets ---------------------
    errs, abs_err, ratio = {}, 0.0, 0.0
    for tag, args in zip(("initial", "perturbed"), sets):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        g_rows, w_rows = _stat_rows(got, n), _stat_rows(want, n)
        s_rows = _stat_rows(BK.gn_stats_rounding_scale(want), n)
        for block in g_rows:
            e = _compare(g_rows[block], w_rows[block], rtol, atol_frac,
                         s_rows[block])
            errs[f"{tag}.{block}"] = e
            abs_err, ratio = max(abs_err, e["abs"]), max(ratio, e["ratio"])
        if tag == "perturbed":
            # Planted faults the check must reject.
            bad_cost = got.clone()
            bad_cost[:, -1] *= 2
            bad_a00 = got.clone()
            bad_a00[:, 0] = 0
            for fault, bad, block in (("cost x 2", bad_cost, "cost"),
                                      ("JtWJ(0,0) = 0", bad_a00, "JtWJ")):
                seen = _compare(_stat_rows(bad, n)[block], w_rows[block],
                                rtol, atol_frac, s_rows[block])["ratio"]
                print(f"  {name}: a planted fault ({fault}) reads "
                      f"error/allowed={seen:.3e}", flush=True)
                if seen <= 1.0:
                    failures.append(f"{name}'s check passes a planted "
                                    f"fault ({fault})")
    ok = ratio <= 1.0
    args = sets[0]
    ms, ahead, gate = _device_ms(lambda: kernel(*args))
    call_ms = _call_ms(lambda: kernel(*args))
    plain_ms = _device_ms(lambda: plain(*args))[0]
    out = kernel(*args)
    nbytes = _nbytes(*[a for a in args if torch.is_tensor(a)], out)
    ops_cam = BGN_OPS_PLANAR if planar else BGN_OPS_6DOF
    ops = B * P * (ops_cam * (2 if stereo else 1)
                   + (BGN_OPS_RIG if stereo else 0))
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"kernel {name}: max_abs_err={abs_err:.3e}, error/allowed="
          f"{ratio:.3e} (rtol {rtol:.0e} of each entry's rounding scale: "
          f"{why}) {'ok' if ok else 'MISS'}; ms={ms:.4f} "
          f"(queued ahead: {ahead}, {gate}) call_ms={call_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    for k, e in errs.items():
        print(f"  {name}.{k}: " + " ".join(
            f"{key}={v:.2e}" for key, v in e.items()), flush=True)
    if not ok:
        failures.append(f"{name} disagrees with its plain version: error "
                        f"{ratio:.3e} times what is allowed")
    if not ahead:
        failures.append(f"{name}: the host did not keep ahead of the card "
                        f"({gate}), so ms is not the kernel's time")
    entry = dict(
        name=name, route="cuda",
        source="bundle_adjustment_solver_tpu_torch/csrc/pose_only_batched.cu",
        replaces=("bundle_adjustment_solver_tpu/ops/pallas/"
                  f"pose_only_batched.py:{line}"),
        launches=None, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    kernels.append(entry)
    del sets, frames, out, args

    # -- the main path: the solve through the public entry point -------------
    if planar:
        chain = (t["poses_world_to_last"], t["poses_world_to_current_init"])
        if stereo:
            solve = port.solve_stereo_planar3dof_batched
            solve_args = (t["points"], t["pixels_left"], t["pixels_right"],
                          t["valid"], t["intrinsics"], t["intrinsics"],
                          t["base_to_camera"], t["pose_left_to_right"]) + chain
        else:
            solve = port.solve_monocular_planar3dof_batched
            solve_args = (t["points"], t["pixels_left"], t["valid"],
                          t["intrinsics"], t["base_to_camera"]) + chain
    elif stereo:
        solve = port.solve_stereo_6dof_batched
        solve_args = (t["points"], t["pixels_left"], t["pixels_right"],
                      t["valid"], t["intrinsics"], t["intrinsics"],
                      t["pose_left_to_right"], t["poses_initial"])
    else:
        solve = port.solve_monocular_6dof_batched
        solve_args = (t["points"], t["pixels_left"], t["valid"],
                      t["intrinsics"], t["poses_initial"])

    def options(thr, iters):
        return Options(convergence_handle=ConvergenceHandle(thr, thr),
                       outlier_handle=OutlierHandle(1.0, 2.5),
                       iteration_handle=IterationHandle(iters),
                       record_history=False)

    def zero_counts():
        for fn in counted:
            setattr(fn, "calls" if hasattr(fn, "calls") else "launches", 0)

    zero_counts()
    t0 = time.perf_counter()
    res = solve(*solve_args, options(1e-7, BATCH_MAX_ITERATIONS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entry["launches"] = kernel.launches
    plain_calls = sum(fn.calls for fn in counted if hasattr(fn, "calls"))
    iters = res.num_iterations.cpu().numpy()
    pose = res.pose.cpu().double().numpy()
    err = float(np.abs(pose - truth).max()) if np.isfinite(pose).all() \
        else float("inf")
    n_ok, n_conv = int(res.success.sum()), int(res.converged.sum())
    print(f"solve {mode}: {B} frames x {P} points, {wall:.3f} s wall, "
          f"iterations per frame {int(iters.min())}-{int(iters.max())} "
          f"(median {float(np.median(iters))}), {kernel.launches} launches, "
          f"{plain_calls} plain-version calls; {n_ok} succeeded, {n_conv} "
          f"converged; max |pose - truth| {err:.3e}", flush=True)
    if tuple(res.pose.shape) != (B, 4, 4):
        failures.append(f"solve {mode}: pose shape {tuple(res.pose.shape)}")
    if kernel.launches == 0:
        failures.append(f"kernel {name} was not launched by its solve")
    if plain_calls:
        failures.append(f"plain versions ran {plain_calls} times in the "
                        f"{mode} solve")
    if n_ok != B or n_conv != B:
        failures.append(f"solve {mode}: {B - n_ok} frames failed, "
                        f"{B - n_conv} did not converge")
    if not err <= POSE_ERR_LIMIT:
        failures.append(f"solve {mode}: max |pose - truth| {err:.3e} > "
                        f"{POSE_ERR_LIMIT}")

    # -- forced iterations: the lockstep rate ---------------------------------
    zero_counts()
    t0 = time.perf_counter()
    solve(*solve_args, options(0.0, FORCED_ITERATIONS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    rate = FORCED_ITERATIONS / wall
    share = launches * ms / (wall * 1e3)
    # Host glue: tensor operations dispatched per lockstep iteration, from
    # two short forced solves (8 and 4 iterations) with a counting mode on.
    per_iter = (_dispatched_ops(lambda: solve(*solve_args, options(0.0, 8)))
                - _dispatched_ops(lambda: solve(*solve_args, options(0.0, 4)))
                ) / 4
    print(f"forced {mode}: {FORCED_ITERATIONS} lockstep iterations in "
          f"{wall:.3f} s: {rate:.1f} iterations/s, {n_obs * rate:.4e} "
          f"observations x iterations/s ({n_obs} observations); "
          f"{launches} launches x {ms:.4f} ms = {100 * share:.2f}% "
          f"of the wall; {per_iter:.0f} tensor operations dispatched per "
          f"iteration, {1e6 * wall / FORCED_ITERATIONS / per_iter:.2f} us "
          f"of wall each", flush=True)


def _dispatched_ops(run) -> int:
    """Number of aten operations (views included) that `run` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return Count.n


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
        ms, ahead, gate = _device_ms(fns[0])
        plain_ms = _device_ms(fns[1])[0]
        call_ms = _call_ms(fns[0])
        bound_ms, bound_by = _bound(nbytes, ops)
        ok = ratio <= 1.0
        print(f"kernel {name}: max_abs_err={abs_err:.3e}, error/allowed="
              f"{ratio:.3e} (rtol {rtol:.0e}, atol {atol_frac:.0e} of the "
              f"row's largest: {why}) {'ok' if ok else 'MISS'}; ms={ms:.4f} "
              f"(queued ahead: {ahead}, {gate}) call_ms={call_ms:.4f} "
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
                            f"card ({gate}), so ms is not the kernel's time")
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

    # -- the batched pose-only paths ---------------------------------------
    from bundle_adjustment_solver_tpu_torch.ops.cuda import (
        pose_only_batched as BK)
    counted = list(counters.values()) + list(plains) + [
        BK.batched_mono_gn_stats, BK.batched_stereo_gn_stats,
        BK.batched_planar_mono_gn_stats, BK.batched_planar_stereo_gn_stats,
        BK.batched_mono_gn_stats_plain, BK.batched_stereo_gn_stats_plain,
        BK.batched_planar_mono_gn_stats_plain,
        BK.batched_planar_stereo_gn_stats_plain]
    for mode in BATCH_SEEDS:
        _batched_phase(mode, dev, kernels, failures, counted)

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
