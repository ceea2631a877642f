"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA card. This file imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Two layouts: a narrow pose window (staged in shared memory) and one wider
than 256 rows (read from device memory, panels summed in device memory).
Outputs are held element by element: a relative tolerance plus a small
fraction of the output row's largest magnitude, for FMA contraction,
another summation order, and atomics that sum panels in a run-dependent
order; the CG step's outputs cancel and are held to their float32 rounding
scale.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu_torch import pm_problem_from_arrays, solve_pm
from bundle_adjustment_solver_tpu_torch.ops.cuda import cg_step as CG
from bundle_adjustment_solver_tpu_torch.ops.cuda import full_ba_pm as K
from bundle_adjustment_solver_tpu_torch.ops.sym6 import inverse_tri6
from bundle_adjustment_solver_tpu_torch.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    SolverType,
)
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
