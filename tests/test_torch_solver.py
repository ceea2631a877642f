"""The port's point-major solve on the CPU against the JAX package's
`solve_pm`, on the same corridor problem (numpy inputs from a seed).

Tolerance: the JAX engine's panels and matvecs carry hi/lo bf16-pair
rounding (~2^-16 relative) into every PCG solve, the port's are exact
float32, so the LM iterates drift apart by about that much per iteration.
`cg_forcing="fixed"` pins the inner-CG budget, which an adaptive forcing
sequence would make sensitive to reduction order.
"""

import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu import options as JO
from bundle_adjustment_solver_tpu.solvers import full_ba_pm as J
from bundle_adjustment_solver_tpu_torch import options as PO
from bundle_adjustment_solver_tpu_torch.solvers import full_ba_pm as P
from bundle_adjustment_solver_tpu_torch.utils.synthetic import corridor_ba_problem

torch.set_num_threads(2)  # six xdist workers share the host's cores

NUM_POSES, NUM_POINTS = 40, 3000


def _arrays(fixed_ids):
    prob = corridor_ba_problem(num_poses=NUM_POSES, num_points=NUM_POINTS,
                               window=5, seed=3)
    fixed = np.zeros(NUM_POSES, bool)
    fixed[list(fixed_ids)] = True
    return (prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point,
            prob.obs_pixel), fixed


def _options(module, solver, **kw):
    return module.Options(
        solver_type=getattr(module.SolverType, solver),
        convergence_handle=module.ConvergenceHandle(0.0, 0.0),
        iteration_handle=module.IterationHandle(8),
        reduced_system="cg", cg_max_iterations=25, cg_tolerance=1e-10,
        cg_forcing="fixed", **kw,
    )


def _solve_both(solver, fixed_ids=(0, 1), **kw):
    args, fixed = _arrays(fixed_ids)
    jp, js, jpm, jps = J.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                layout="host")
    j_state, j_sum = J.solve_pm(jp, js, _options(JO, solver, **kw),
                                pm_and_shape=(jpm, jps))
    pp, ps, ppm, pps = P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                device="cpu")
    p_state, p_sum = P.solve_pm(pp, ps, _options(PO, solver, **kw),
                                (ppm, pps))
    return (j_state, j_sum, jps), (p_state, p_sum, pps)


def _assert_close(j_state, j_sum, p_state):
    # The cost falls by orders of magnitude over a solve; rounding
    # differences stay relative to where it started.
    first_cost = j_sum.optimization_info_list[0].cost
    np.testing.assert_allclose(float(p_state.final_cost),
                               float(j_state.final_cost), rtol=1e-4,
                               atol=2e-5 * first_cost)
    np.testing.assert_allclose(float(p_state.final_rmse_px),
                               float(j_state.final_rmse_px), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(p_state.points.numpy(),
                               np.asarray(j_state.points), rtol=0, atol=2e-4)
    np.testing.assert_allclose(p_state.poses_world_to_camera.numpy(),
                               np.asarray(j_state.poses_world_to_camera),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "solver,kw",
    [
        ("LEVENBERG_MARQUARDT", dict(cg_fused_step=True)),
        ("LEVENBERG_MARQUARDT", dict(cg_fused_step=False)),
        ("GAUSS_NEWTON", dict()),
    ],
    ids=["lm-fused", "lm-unfused", "gn"],
)
def test_solve_pm_matches_jax(solver, kw):
    (j_state, j_sum, jps), (p_state, p_sum, pps) = _solve_both(solver, **kw)
    assert pps.opt_start == jps.opt_start == 2  # contiguous opt range
    _assert_close(j_state, j_sum, p_state)
    costs = [i.cost for i in p_sum.optimization_info_list]
    assert costs[-1] < 0.1 * costs[0]
    assert len(p_sum.optimization_info_list) == len(
        j_sum.optimization_info_list) == 8
    statuses = [int(i.iteration_status) for i in p_sum.optimization_info_list]
    assert statuses == [int(i.iteration_status)
                        for i in j_sum.optimization_info_list]


def test_solve_pm_matches_jax_noncontiguous_opt_range():
    """Fixed poses at both ends and in the middle: the opt poses are no
    single row range, so the pose update takes the indexed gather/scatter."""
    (j_state, j_sum, jps), (p_state, _, pps) = _solve_both(
        "LEVENBERG_MARQUARDT", fixed_ids=(0, 17, 39)
    )
    assert pps.opt_start is None and jps.opt_start is None
    _assert_close(j_state, j_sum, p_state)
