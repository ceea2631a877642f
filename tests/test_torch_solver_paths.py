"""Further paths of the port's point-major solver on the CPU: a layout
carried over from the JAX package (`convert.from_jax_numpy`), gradient
descent, per-iteration timing, and the options a later slice ports.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu import options as JO
from bundle_adjustment_solver_tpu.solvers import full_ba_pm as J
from bundle_adjustment_solver_tpu_torch import options as PO
from bundle_adjustment_solver_tpu_torch.convert import from_jax_numpy
from bundle_adjustment_solver_tpu_torch.solvers import full_ba_pm as P
from bundle_adjustment_solver_tpu_torch.utils.synthetic import corridor_ba_problem

torch.set_num_threads(2)  # six xdist workers share the host's cores


def _arrays():
    prob = corridor_ba_problem(num_poses=24, num_points=900, window=5, seed=9)
    fixed = np.zeros(24, bool)
    fixed[prob.fixed_pose_ids] = True
    return (prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point,
            prob.obs_pixel), fixed


def _options(module, solver="LEVENBERG_MARQUARDT", iters=6, **kw):
    return module.Options(
        solver_type=getattr(module.SolverType, solver),
        convergence_handle=module.ConvergenceHandle(0.0, 0.0),
        iteration_handle=module.IterationHandle(iters),
        reduced_system="cg", cg_max_iterations=20, cg_tolerance=1e-10,
        cg_forcing="fixed", **kw,
    )


def test_from_jax_numpy_gives_identical_solves():
    """The JAX package's layout carried into the port solves bit-identically
    to the port's own layout built with the same block padding, and close
    to the JAX package's own solve."""
    args, fixed = _arrays()
    jp, js, jpm, jps = J.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                layout="host")
    # The JAX entry pads the block count to a multiple of 2 (its default
    # grid group); the port's builder gets the same padding here.
    pp, ps, ppm, pps = P.pm_problem_from_arrays(
        *args, fixed_pose_mask=fixed, pad_blocks_to=2, device="cpu")
    assert dataclasses.asdict(pps) == dataclasses.asdict(jps)
    rig_fields = ("fx", "fy", "cx", "cy", "R_cam_from_ref", "t_cam_from_ref")
    cpm, cps, crig, ctbl = from_jax_numpy(
        {k: np.asarray(v) for k, v in jpm._asdict().items()},
        dataclasses.asdict(jps),
        {k: np.asarray(getattr(jp.rig, k)) for k in rig_fields},
        np.asarray(jp.R_cw), np.asarray(jp.t_cw), "cpu",
    )
    N = cps.num_poses
    conv_problem = pp._replace(rig=crig, R_cw=ctbl[:N, :9].reshape(N, 3, 3),
                               t_cw=ctbl[:N, 9:12])
    a, sa = P.solve_pm(conv_problem, ps, _options(PO), (cpm, cps))
    b, sb = P.solve_pm(pp, ps, _options(PO), (ppm, pps))
    for name in ("poses_world_to_camera", "points", "final_cost",
                 "final_rmse_px", "info"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0, msg=name)
    j_state, _ = J.solve_pm(jp, js, _options(JO), pm_and_shape=(jpm, jps))
    np.testing.assert_allclose(float(a.final_cost), float(j_state.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(a.points.numpy(), np.asarray(j_state.points),
                               rtol=0, atol=2e-4)


def test_gradient_descent_matches_jax():
    args, fixed = _arrays()
    jp, js, jpm, jps = J.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                layout="host")
    pp, ps, ppm, pps = P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                device="cpu")
    j_state, _ = J.solve_pm(jp, js, _options(JO, "GRADIENT_DESCENT", 4),
                            pm_and_shape=(jpm, jps))
    p_state, p_sum = P.solve_pm(pp, ps, _options(PO, "GRADIENT_DESCENT", 4),
                                (ppm, pps))
    np.testing.assert_allclose(float(p_state.final_cost),
                               float(j_state.final_cost), rtol=1e-5)
    assert all(i.cg_iterations == 0 for i in p_sum.optimization_info_list)


def test_time_iterations_reports_times_and_changes_nothing():
    args, fixed = _arrays()
    pp, ps, ppm, pps = P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                device="cpu")
    opts = _options(PO, iters=5).replace(
        convergence_handle=PO.ConvergenceHandle(1e-8, 1e-8))
    a, sa = P.solve_pm(pp, ps, opts, (ppm, pps))
    b, sb = P.solve_pm(pp, ps, opts.replace(time_iterations=True), (ppm, pps))
    torch.testing.assert_close(a.poses_world_to_camera,
                               b.poses_world_to_camera, rtol=0, atol=0)
    assert all(i.iter_time == -1.0 for i in sa.optimization_info_list)
    assert len(sb.optimization_info_list) == len(sa.optimization_info_list)
    assert all(i.iter_time > 0.0 for i in sb.optimization_info_list)
    assert sb.total_time_in_millisecond > 0.0
    assert "Final RMSE" in sb.brief_report()


def test_fused_and_unfused_pcg_take_the_same_cg_steps():
    args, fixed = _arrays()
    pp, ps, ppm, pps = P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                device="cpu")
    opts = _options(PO, iters=6).replace(cg_forcing="ew")
    a, sa = P.solve_pm(pp, ps, opts, (ppm, pps))
    b, sb = P.solve_pm(pp, ps, opts.replace(cg_fused_step=False), (ppm, pps))
    assert [i.cg_iterations for i in sa.optimization_info_list] == [
        i.cg_iterations for i in sb.optimization_info_list]
    np.testing.assert_allclose(float(a.final_cost), float(b.final_cost),
                               rtol=1e-4)


@pytest.mark.parametrize(
    "change",
    [dict(coupling_dtype="bfloat16"), dict(cg_precond="schur_jacobi"),
     dict(time_iterations="device")],
    ids=lambda c: next(iter(c)),
)
def test_options_of_later_slices_raise(change):
    args, fixed = _arrays()
    pp, ps, ppm, pps = P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed,
                                                device="cpu")
    with pytest.raises(NotImplementedError):
        P.solve_pm(pp, ps, PO.Options().replace(**change), (ppm, pps))


def test_device_layout_build_is_not_ported_yet():
    args, fixed = _arrays()
    with pytest.raises(NotImplementedError, match="layout"):
        P.pm_problem_from_arrays(*args, fixed_pose_mask=fixed, layout="device",
                                 device="cpu")
