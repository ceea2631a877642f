"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA card. This file imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Point-major kernels: two layouts, a narrow pose window (staged in shared
memory) and one wider than 256 rows (read from device memory, panels summed
in device memory). Batched pose-only kernels: 300 frames of 300 points (more
points than a block has threads), and each batched solve on the card
against the same solve on the CPU.
Outputs are held element by element: a relative tolerance plus a small
fraction of the output row's largest magnitude, for FMA contraction,
another summation order, and atomics that sum panels in a run-dependent
order; the CG step's outputs and the batched stats cancel and are held to
their float32 rounding scale.
"""

import numpy as np
import pytest
import torch

import bundle_adjustment_solver_tpu_torch as port
from bundle_adjustment_solver_tpu_torch import pm_problem_from_arrays, solve_pm
from bundle_adjustment_solver_tpu_torch.convert import batched_problem_tensors
from bundle_adjustment_solver_tpu_torch.ops.cuda import cg_step as CG
from bundle_adjustment_solver_tpu_torch.ops.cuda import full_ba_pm as K
from bundle_adjustment_solver_tpu_torch.ops.cuda import pose_only_batched as BK
from bundle_adjustment_solver_tpu_torch.ops.sym6 import inverse_tri6
from bundle_adjustment_solver_tpu_torch.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
    SolverType,
)
from bundle_adjustment_solver_tpu_torch.solvers import pose_only
from bundle_adjustment_solver_tpu_torch.utils.synthetic import corridor_ba_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(device, wide):
    n = 700 if wide else 60
    prob = corridor_ba_problem(num_poses=n, num_points=4000, window=4, seed=21)
    obs_pose = prob.obs_pose.copy()
    if wide:
        # Long-range observations stretch each block's pose window past
        # the shared-memory limit.
        sel = np.random.default_rng(4).random(obs_pose.shape[0]) < 0.05
        obs_pose[sel] = (obs_pose[sel] + n // 2) % n
    tri = prob.obs_point.astype(np.int64) * (2 * n) + obs_pose * 2 + prob.obs_camera
    _, first = np.unique(tri, return_index=True)
    keep = np.zeros(obs_pose.shape[0], bool)
    keep[first] = True
    fixed = np.zeros(n, bool)
    fixed[prob.fixed_pose_ids] = True
    return pm_problem_from_arrays(
        prob.cameras, prob.poses_initial, prob.points_initial,
        prob.obs_camera[keep], obs_pose[keep], prob.obs_point[keep],
        prob.obs_pixel[keep], fixed_pose_mask=fixed, device=device,
    )


def _ratio(got, want, rtol, atol_frac=0.0, scale=None):
    """Largest element-wise error over what is allowed: rtol times `scale`
    (default |want|) plus atol_frac times the largest |want| of the
    element's row (rows are the first axis). At most 1 passes."""
    g = got.double().reshape(got.shape[0], -1) if got.dim() else got.double().reshape(1, 1)
    w = want.double().reshape(g.shape)
    s = w.abs() if scale is None else scale.double().abs().reshape(g.shape)
    allowed = rtol * s + atol_frac * w.abs().amax(dim=1, keepdim=True)
    d = (g - w).abs()
    return float(torch.where(allowed > 0, d / allowed.clamp_min(1e-300),
                             torch.where(d > 0, torch.inf, 0.0)).max())


# (rtol, atol as a fraction of the row's largest magnitude), as chip_smoke.py
# holds the kernels at the flagship size.
ASSEMBLE_TOL = (1e-4, 1e-5)
MATVEC_TOL = (2e-5, 2e-6)
COST_RTOL = 1e-6
CG_STEP_RTOL = 1e-6  # of each output's float32 rounding scale


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_kernels_match_plain_versions(cuda, wide):
    problem, _, pm, ps = _problem(cuda, wide)
    assert (ps.window > 256) == wide
    tbl = K.pose_table(problem.R_cw, problem.t_cw, ps.window)
    cam = K._cam_table(problem.rig)
    scal = K._scalars(3.0, 0.01, cuda)
    cols = lambda pan: pan.permute(2, 0, 1)  # one row per panel column

    launches = K.assemble_pm_blocks.launches
    U, Cb, pan = K.assemble_pm_blocks(pm, ps, tbl, pm.X, cam, scal)
    assert K.assemble_pm_blocks.launches == launches + 1
    U_q, Cb_q, pan_q = K.assemble_pm_blocks_plain(pm, ps, tbl, pm.X, cam, scal)
    assert _ratio(U, U_q, *ASSEMBLE_TOL) <= 1
    assert _ratio(Cb, Cb_q, *ASSEMBLE_TOL) <= 1
    assert _ratio(cols(pan), cols(pan_q), *ASSEMBLE_TOL) <= 1

    x_tbl = torch.zeros((ps.num_opt_poses + ps.window, 8), device=cuda)
    x_tbl[: ps.num_opt_poses, :6] = torch.randn(
        (ps.num_opt_poses, 6), generator=torch.Generator().manual_seed(0)
    ).to(cuda)
    for mode in ("matvec", "rhs"):
        p_k, t_k = K.matvec_pm_blocks(pm, ps, Cb, U, x_tbl, mode)
        p_q, t_q = K.matvec_pm_blocks_plain(pm, ps, Cb, U, x_tbl, mode)
        assert _ratio(cols(p_k), cols(p_q), *MATVEC_TOL) <= 1
        assert _ratio(t_k[:3], t_q[:3], *MATVEC_TOL) <= 1
        assert bool((t_k[3] == 0).all())

    c_k = K.cost_pm_blocks(pm, ps, tbl, pm.X, cam, scal).sum(0)
    c_q = K.cost_pm_blocks_plain(pm, ps, tbl, pm.X, cam, scal).sum(0)
    assert _ratio(c_k, c_q, COST_RTOL) <= 1

    flat = K._second_level(pan, pm.sbase, ps.num_opt_poses, ps.window, K.A_COLS)
    Atri, _, rhs = K.finish_pose_system_tri(flat, 3.0)
    n = ps.num_opt_poses
    Np = CG.padded_poses(n)
    AP = torch.zeros((42, Np), device=cuda)
    AP[:21, :n] = Atri.T
    AP[21:, :n] = inverse_tri6(Atri).T
    r = CG.to_planes(rhs, Np)
    p = CG.plane_sym6_matvec(AP[21:], r)
    args = (AP, 0.1 * p, torch.zeros_like(r), r, p, torch.sum(r * p))
    out_k = CG.cg_pose_step(*args)
    out_q = CG.cg_pose_step_plain(*args)
    scales = CG.cg_pose_step_rounding_scale(
        *[t.double() for t in args], [t.double() for t in out_q])
    for got, want, s in zip(out_k, out_q, scales):
        assert _ratio(got, want, CG_STEP_RTOL, scale=s) <= 1
    # The check sees a wrong r' or rr.
    assert _ratio(torch.zeros_like(out_k[1]), out_q[1], CG_STEP_RTOL, scale=scales[1]) > 1
    assert _ratio(2 * out_k[5], out_q[5], CG_STEP_RTOL, scale=scales[5]) > 1
    for got in out_k[:3]:
        assert bool((got[:, n:] == 0).all())  # padded lanes stay zero


def test_solve_on_the_card_matches_the_cpu(cuda):
    problem, shape, pm, ps = _problem(cuda, wide=False)
    cpu = _problem("cpu", wide=False)
    opts = Options(
        solver_type=SolverType.LEVENBERG_MARQUARDT,
        convergence_handle=ConvergenceHandle(0.0, 0.0),
        iteration_handle=IterationHandle(10),
        reduced_system="cg", cg_max_iterations=25, cg_tolerance=1e-10,
        cg_forcing="fixed",
    )
    plain_calls = K.assemble_pm_blocks_plain.calls
    g_state, g_sum = solve_pm(problem, shape, opts, (pm, ps))
    assert K.assemble_pm_blocks_plain.calls == plain_calls
    c_state, c_sum = solve_pm(cpu[0], cpu[1], opts, (cpu[2], cpu[3]))
    first = c_sum.optimization_info_list[0].cost
    np.testing.assert_allclose(float(g_state.final_cost),
                               float(c_state.final_cost), rtol=1e-4,
                               atol=2e-5 * first)
    np.testing.assert_allclose(g_state.points.cpu().numpy(),
                               c_state.points.numpy(), rtol=0, atol=2e-4)


# Batched pose-only stats, as chip_smoke.py holds them: rtol of each entry's
# rounding scale (a bound on the sum of its terms' magnitudes).
BGN_RTOL = 2e-4
BGN_MODES = ["mono", "stereo", "planar_mono", "planar_stereo"]


def _batched(mode, device, B, P, seed, noise=0.0):
    import dataclasses

    if mode.startswith("planar"):
        prob = port.batched_planar_pose_only_problem(
            B, P, seed=seed, stereo=mode == "planar_stereo",
            pixel_noise=noise)
    else:
        prob = port.batched_stereo_pose_only_problem(B, P, seed=seed,
                                                     pixel_noise=noise)
    arrays = dataclasses.asdict(prob)
    arrays["valid"] = np.random.default_rng(seed).uniform(size=(B, P)) > 0.05
    return prob, batched_problem_tensors(arrays, device)


def _bgn_args(mode, t):
    """The stats kernel's arguments, laid out as the solver lays them out,
    at a pose off the truth."""
    frames = pose_only.batched_frames(mode, t)
    B, dev = t["points"].shape[0], t["points"].device
    gen = torch.Generator().manual_seed(3)
    if mode.startswith("planar"):
        state = t["theta_true"] + 0.01 * torch.randn(
            (B, 3), generator=gen).to(dev)
    else:
        T = torch.linalg.inv(t["poses_true"])
        T[:, :3, 3] += 0.02 * torch.randn((B, 3), generator=gen).to(dev)
        state = BK.pose_rows(T[:, :3, :3].contiguous(), T[:, :3, 3])
    return pose_only.stats_args(frames, state, 1.0)


_BGN = {
    "mono": (BK.batched_mono_gn_stats, BK.batched_mono_gn_stats_plain),
    "stereo": (BK.batched_stereo_gn_stats, BK.batched_stereo_gn_stats_plain),
    "planar_mono": (BK.batched_planar_mono_gn_stats,
                    BK.batched_planar_mono_gn_stats_plain),
    "planar_stereo": (BK.batched_planar_stereo_gn_stats,
                      BK.batched_planar_stereo_gn_stats_plain),
}


@pytest.mark.parametrize("mode", BGN_MODES)
def test_batched_stats_kernel_matches_plain(cuda, mode):
    _, t = _batched(mode, cuda, B=300, P=300, seed=9, noise=1.0)
    args = _bgn_args(mode, t)
    kernel, plain = _BGN[mode]
    launches = kernel.launches
    got = kernel(*args)
    assert kernel.launches == launches + 1
    want = plain(*args)
    torch.cuda.synchronize()
    scale = BK.gn_stats_rounding_scale(want)
    assert _ratio(got, want, BGN_RTOL, scale=scale) <= 1
    # The check sees a doubled cost and a zeroed J^T W J (0, 0).
    bad = got.clone()
    bad[:, -1] *= 2
    assert _ratio(bad, want, BGN_RTOL, scale=scale) > 1
    bad = got.clone()
    bad[:, 0] = 0
    assert _ratio(bad, want, BGN_RTOL, scale=scale) > 1


@pytest.mark.parametrize("mode", BGN_MODES)
def test_batched_solve_on_the_card_matches_the_cpu(cuda, mode):
    # Noise-free: with pixel noise the last steps hover at the 1e-7
    # thresholds, so either side's stopping iteration is chaotic.
    _, t_gpu = _batched(mode, cuda, B=64, P=128, seed=4)
    _, t_cpu = _batched(mode, "cpu", B=64, P=128, seed=4)
    solve = {"mono": port.solve_monocular_6dof_batched,
             "stereo": port.solve_stereo_6dof_batched,
             "planar_mono": port.solve_monocular_planar3dof_batched,
             "planar_stereo": port.solve_stereo_planar3dof_batched}[mode]

    def args(t):
        if mode == "mono":
            return (t["points"], t["pixels_left"], t["valid"],
                    t["intrinsics"], t["poses_initial"])
        if mode == "stereo":
            return (t["points"], t["pixels_left"], t["pixels_right"],
                    t["valid"], t["intrinsics"], t["intrinsics"],
                    t["pose_left_to_right"], t["poses_initial"])
        chain = (t["poses_world_to_last"], t["poses_world_to_current_init"])
        if mode == "planar_mono":
            return (t["points"], t["pixels_left"], t["valid"],
                    t["intrinsics"], t["base_to_camera"]) + chain
        return (t["points"], t["pixels_left"], t["pixels_right"], t["valid"],
                t["intrinsics"], t["intrinsics"], t["base_to_camera"],
                t["pose_left_to_right"]) + chain

    opts = Options(convergence_handle=ConvergenceHandle(1e-7, 1e-7),
                   outlier_handle=OutlierHandle(1.0, 2.5),
                   iteration_handle=IterationHandle(40))
    plain = _BGN[mode][1]
    calls = plain.calls
    g = solve(*args(t_gpu), opts)
    assert plain.calls == calls  # the card ran the kernel, not the plain version
    c = solve(*args(t_cpu), opts, device="cpu")
    assert bool(g.success.all()) and bool(g.converged.all())
    np.testing.assert_allclose(g.pose.cpu().numpy(), c.pose.numpy(), atol=3e-5)
    assert (g.num_iterations.cpu() - c.num_iterations).abs().max() <= 1
    assert (g.mask_inlier.cpu() == c.mask_inlier).float().mean() > 0.99
