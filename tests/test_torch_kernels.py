"""Each kernel wrapper of the port, run on CPU tensors (its plain version),
against the JAX package's entry point for the same kernel (Pallas in
interpret mode), on one identical layout: the JAX builder's layout, carried
over with `convert.from_jax_numpy`.

Tolerances: the JAX kernels gather pose rows exactly (HIGHEST-precision
one-hot dots), so U, C, Cinv, b and the costs agree to float32 rounding;
their A/a scatter and the whole matvec use hi/lo bf16-pair one-hot dots
(~2^-16 relative) while the port indexes in exact float32, so panels and
matvec outputs get the JAX package's own parity tolerances
(tests/test_full_ba_pm.py: rtol 3e-4 panels, 1e-4 matvec).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu.models import layout as jax_layout
from bundle_adjustment_solver_tpu.models.camera import CameraRig as JaxRig
from bundle_adjustment_solver_tpu.ops import sym6 as jax_sym6
from bundle_adjustment_solver_tpu.ops.pallas import cg_step as jax_cg
from bundle_adjustment_solver_tpu.ops.pallas import full_ba_pm as JK
from bundle_adjustment_solver_tpu_torch.convert import from_jax_numpy
from bundle_adjustment_solver_tpu_torch.ops import sym6 as port_sym6
from bundle_adjustment_solver_tpu_torch.ops.cuda import cg_step as port_cg
from bundle_adjustment_solver_tpu_torch.ops.cuda import full_ba_pm as PK
from bundle_adjustment_solver_tpu_torch.utils.synthetic import corridor_ba_problem

torch.set_num_threads(2)  # six xdist workers share the host's cores

SCALE = 0.01


def _layouts(num_fixed_points=0, seed=7):
    """The JAX layout of a small corridor problem and the same layout in
    the port, plus the scaled poses and both rigs."""
    prob = corridor_ba_problem(num_poses=14, num_points=400, window=4,
                               seed=seed)
    N, M = 14, 400
    fixed_pose = np.zeros(N, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    n_opt = int((~fixed_pose).sum())
    pose_opt_of = np.full(N, n_opt, np.int32)
    pose_opt_of[~fixed_pose] = np.arange(n_opt, dtype=np.int32)
    point_is_opt = np.ones(M, bool)
    point_is_opt[:num_fixed_points] = False
    pm_j, ps_j = jax_layout.build_point_major(
        prob.obs_pose, prob.obs_point, prob.obs_camera,
        prob.obs_pixel * SCALE, prob.points_initial * SCALE, pose_opt_of,
        point_is_opt, 2, SCALE, num_opt_poses=n_opt, block_points=128,
    )
    R_wc = prob.poses_initial[:, :3, :3]
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, prob.poses_initial[:, :3, 3]) * SCALE
    R_cw, t_cw = R_cw.astype(np.float32), t_cw.astype(np.float32)
    rig_j = JaxRig.from_cameras(prob.cameras, scale=SCALE)
    pm_p, ps_p, rig_p, tbl_p = from_jax_numpy(
        {k: np.asarray(v) for k, v in pm_j._asdict().items()},
        dataclasses.asdict(ps_j),
        {k: np.asarray(getattr(rig_j, k)) for k in
         ("fx", "fy", "cx", "cy", "R_cam_from_ref", "t_cam_from_ref")},
        R_cw, t_cw, "cpu",
    )
    tbl_j = JK.pose_table(jnp.asarray(R_cw), jnp.asarray(t_cw), ps_j.window)
    np.testing.assert_array_equal(tbl_p.numpy(), np.asarray(tbl_j))
    return (pm_j, ps_j, rig_j, tbl_j), (pm_p, ps_p, rig_p, tbl_p)


def _close(got, want, rtol, atol_frac=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=rtol, atol=atol_frac * np.abs(want).max()
    )


@pytest.mark.parametrize("num_fixed_points", [0, 17])
def test_assemble_matches_jax(num_fixed_points):
    (pm_j, ps_j, rig_j, tbl_j), (pm_p, ps_p, rig_p, tbl_p) = _layouts(
        num_fixed_points
    )
    lam, huber = 2.0, 1.0 * SCALE
    flat_j, Cb_j, U_j = JK.assemble_pm_tbl(
        pm_j, ps_j, tbl_j, pm_j.X, rig_j, jnp.float32(lam), huber,
        interpret=True,
    )
    calls = PK.assemble_pm_blocks_plain.calls
    flat_p, Cb_p, U_p = PK.assemble_pm_tbl(
        pm_p, ps_p, tbl_p, pm_p.X, rig_p, lam, huber
    )
    # CPU tensors take the plain version, never a kernel.
    assert PK.assemble_pm_blocks_plain.calls == calls + 1
    assert PK.assemble_pm_blocks.launches == 0
    _close(U_p, U_j, rtol=1e-5)
    Cb_j = np.asarray(Cb_j)
    for rows in (slice(0, 6), slice(9, 15), slice(15, 16)):
        _close(Cb_p[rows], Cb_j[rows], rtol=1e-5)
    # b is a sum of signed terms that cancel: float32 rounding relative to
    # the plane's largest entry.
    _close(Cb_p[6:9], Cb_j[6:9], rtol=1e-5, atol_frac=1e-5)
    flat_j = np.array(flat_j)
    np.testing.assert_allclose(flat_p.numpy(), flat_j, rtol=3e-4, atol=1e-3)
    # Fixed landmarks drop out of the Schur system exactly.
    mask = pm_p.X[3] == 0
    assert bool((Cb_p[9:15, mask] == 0).all()) and bool((U_p[:, :, mask] == 0).all())
    # The flat damped pose system: same damping, same rhs.
    want = JK.finish_pose_system_tri(jnp.asarray(flat_j), jnp.float32(lam))
    got = PK.finish_pose_system_tri(torch.tensor(flat_j), lam)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6)


def test_matvec_corr_matches_jax():
    (pm_j, ps_j, rig_j, tbl_j), (pm_p, ps_p, rig_p, tbl_p) = _layouts()
    _, Cb_j, U_j = JK.assemble_pm_tbl(
        pm_j, ps_j, tbl_j, pm_j.X, rig_j, jnp.float32(0.5), SCALE,
        interpret=True,
    )
    x = np.random.default_rng(0).standard_normal(
        (ps_j.num_opt_poses, 6)).astype(np.float32)
    corr_j, t_j = JK.matvec_corr_pm(pm_j, ps_j, Cb_j, U_j, jnp.asarray(x),
                                    interpret=True)
    Cb_p = torch.tensor(np.asarray(Cb_j))
    U_p = torch.tensor(np.asarray(U_j))
    corr_p, t_p = PK.matvec_corr_pm(pm_p, ps_p, Cb_p, U_p, torch.from_numpy(x))
    _close(corr_p, corr_j, rtol=1e-4)
    _close(t_p, t_j, rtol=1e-4)


def test_rhs_corr_matches_jax():
    (pm_j, ps_j, rig_j, tbl_j), (pm_p, ps_p, rig_p, tbl_p) = _layouts()
    flat_j, Cb_j, U_j = JK.assemble_pm_tbl(
        pm_j, ps_j, tbl_j, pm_j.X, rig_j, jnp.float32(0.5), SCALE,
        interpret=True,
    )
    rc_j = JK.rhs_corr_pm(pm_j, ps_j, Cb_j, U_j, interpret=True)
    rc_p = PK.rhs_corr_pm(pm_p, ps_p, torch.tensor(np.asarray(Cb_j)),
                          torch.tensor(np.asarray(U_j)))
    _close(rc_p, rc_j, rtol=1e-4)
    # The assembly's fused B Cinv b columns equal the rhs-mode matvec.
    _close(rc_p, np.asarray(flat_j)[:, 27:33], rtol=3e-4, atol_frac=1e-5)


@pytest.mark.parametrize("huber_px", [1.0, 1e-3])
def test_cost_matches_jax(huber_px):
    (pm_j, ps_j, rig_j, tbl_j), (pm_p, ps_p, rig_p, tbl_p) = _layouts()
    huber = huber_px * SCALE  # 1e-3 px puts most residuals on the robust branch
    want = JK.cost_pm_tbl(pm_j, ps_j, tbl_j, pm_j.X, rig_j, huber,
                          interpret=True)
    got = PK.cost_pm_tbl(pm_p, ps_p, tbl_p, pm_p.X, rig_p, huber)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert float(got[3]) == ps_p.num_observations


def test_cg_pose_step_matches_jax():
    rng = np.random.default_rng(11)
    n = 37
    Np = port_cg.padded_poses(n)
    assert Np == jax_cg.padded_poses(n)
    G = rng.normal(size=(n, 6, 6))
    A = G @ np.transpose(G, (0, 2, 1)) + 6.0 * np.eye(6)
    Atri = np.stack([A[:, a, b] for (a, b) in port_sym6._TRI6], 1).astype(
        np.float32)
    Ptri = np.asarray(jax_sym6.inverse_tri6(jnp.asarray(Atri)))
    AP = np.zeros((42, Np), np.float32)
    AP[:21, :n] = Atri.T
    AP[21:, :n] = Ptri.T
    planes = []
    for _ in range(4):  # corr, x, r, p
        v = np.zeros((6, Np), np.float32)
        v[:, :n] = rng.normal(size=(6, n))
        planes.append(v)
    rz = np.float32(np.sum(planes[2] * planes[3]))
    want = jax_cg.cg_pose_step(*map(jnp.asarray, [AP] + planes), rz,
                               interpret=True)
    got = port_cg.cg_pose_step(*map(torch.from_numpy, [AP] + planes),
                               torch.tensor(rz))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, rtol=1e-5)
        assert bool((g[:, n:] == 0).all())  # padded lanes stay zero
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert port_cg.cg_pose_step.launches == 0


def test_wrappers_refuse_other_devices_and_bad_inputs():
    _, (pm_p, ps_p, rig_p, tbl_p) = _layouts()
    cam = PK._cam_table(rig_p)
    scal = PK._scalars(1.0, SCALE, tbl_p.device)
    with pytest.raises(ValueError, match="unsupported device"):
        PK.assemble_pm_blocks(
            pm_p._replace(**{k: v.to("meta") for k, v in pm_p._asdict().items()}),
            ps_p, tbl_p.to("meta"), pm_p.X.to("meta"), cam.to("meta"),
            scal.to("meta"),
        )
    with pytest.raises(ValueError, match="dtype"):
        PK.cost_pm_blocks(pm_p, ps_p, tbl_p.double(), pm_p.X, cam, scal)
    with pytest.raises(ValueError, match="pose table"):
        PK.cost_pm_blocks(pm_p, ps_p, tbl_p[:4], pm_p.X, cam, scal)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        PK.assemble_pm_tbl(pm_p, ps_p, tbl_p, pm_p.X, rig_p, 1.0, SCALE,
                           u_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="schur_jacobi"):
        PK.assemble_pm_tbl(pm_p, ps_p, tbl_p, pm_p.X, rig_p, 1.0, SCALE,
                           emit_schur=True)


@pytest.mark.parametrize(
    "fault", [None, "r_zeroed", "p_zeroed", "alpha_off", "rz_doubled", "rr_doubled"]
)
def test_cg_step_rounding_scale_bounds_float32(fault):
    """The rounding scale that holds the CG step's kernel against its plain
    version on the card: the plain step in float32 stays within 1e-6 of it
    against the same step in float64, element by element, on the first PCG
    iteration of a real system (where r' = r - alpha Sp cancels); a wrong
    output does not."""
    _, (pm, ps, rig, tbl) = _layouts()
    lam = 1e-3
    flat, Cb, U = PK.assemble_pm_tbl(pm, ps, tbl, pm.X, rig, lam, SCALE)
    Atri, _, rhs = PK.finish_pose_system_tri(flat, lam)
    n = ps.num_opt_poses
    Np = port_cg.padded_poses(n)
    AP = torch.zeros((42, Np))
    AP[:21, :n] = Atri.T
    AP[21:, :n] = port_sym6.inverse_tri6(Atri).T
    r = port_cg.to_planes(rhs, Np)
    p = port_cg.plane_sym6_matvec(AP[21:], r)
    corr, _ = PK.matvec_corr_pm(pm, ps, Cb, U, p[:, :n].T)
    args = (AP, port_cg.to_planes(corr, Np), torch.zeros_like(r), r, p,
            torch.sum(r * p))
    got = list(port_cg.cg_pose_step_plain(*args))
    want = port_cg.cg_pose_step_plain(*[t.double() for t in args])
    scales = port_cg.cg_pose_step_rounding_scale(
        *[t.double() for t in args], want)
    i = {"r_zeroed": 1, "p_zeroed": 2, "alpha_off": 3, "rz_doubled": 4,
         "rr_doubled": 5}.get(fault)
    if fault in ("r_zeroed", "p_zeroed"):
        got[i] = torch.zeros_like(got[i])
    elif fault == "alpha_off":
        got[i] = got[i] * (1 + 1e-4)
    elif fault is not None:
        got[i] = 2 * got[i]
    worst = max(
        float(((g.double() - w).abs() / (1e-6 * s).clamp_min(1e-300)).max())
        for g, w, s in zip(got, want, scales)
    )
    assert (worst > 1) == (fault is not None), worst
