"""The port's batched pose-only slice against the JAX package, on the CPU.

Each kernel wrapper runs its plain version on CPU tensors and is held to the
JAX package's `batched_*_gn_stats` (Pallas in interpret mode) on the same
float32 inputs. Each public `solve_*_batched` is held to the JAX package's
fused batched solver (`pallas="interpret"`). Inputs are made from a seed
with numpy and handed to both packages through
`convert.batched_problem_tensors`.

Tolerances:
  * stats: each entry within 4e-5 of its rounding scale
    (`pose_only_batched.gn_stats_rounding_scale`: sqrt(A_aa A_bb) for
    J^T W J (a, b), sqrt(A_aa cost) for J^T W r (a), the cost itself), a
    bound on the sum of the magnitudes of the entry's terms, which is what
    float32 rounding of the sum is relative to. The JAX package holds its
    stats kernels to rtol 2e-5 plus 1e-6 of the 6x6 block's largest entry
    (tests/test_pallas_kernels.py:84-93, 188-197), on one frame. Per stat
    over many frames (rtol 2e-5 plus 1e-6 of the stat's largest magnitude
    over the frames) that bar cannot be met: some stats (for example
    J^T W J (0, 3), whose signed terms cancel over a frame's cloud) end far
    below their terms in every frame, and the Huber weight takes the
    rounding of r = projection - pixel, which is relative to the pixel
    coordinates, not to r. Against the rounding scale the two packages read
    1.2e-5 to 1.5e-5 at this seed, so the limit sits 2.6-3.4x above the
    readings;
  * solves: the JAX package's fused-against-vmap bars
    (tests/test_pallas_kernels.py, TestFusedBatched*): poses atol 3e-5,
    iteration counts within 1 (rounding can move a frame's stop across the
    threshold by one iteration), equal convergence flags, masks agreeing on
    more than 99%, info costs rtol 2e-4 and debug poses atol 3e-5 on the
    common prefix.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu.ops.pallas import pose_only_batched as JB
from bundle_adjustment_solver_tpu.options import (
    ConvergenceHandle as JConvergence,
    IterationHandle as JIteration,
    Options as JOptions,
    OutlierHandle as JOutlier,
)
from bundle_adjustment_solver_tpu.solvers import pose_only as JP
from bundle_adjustment_solver_tpu.utils import synthetic as jax_synthetic
from bundle_adjustment_solver_tpu_torch import (
    solve_monocular_6dof_batched,
    solve_monocular_planar3dof_batched,
    solve_stereo_6dof_batched,
    solve_stereo_planar3dof_batched,
)
from bundle_adjustment_solver_tpu_torch.convert import batched_problem_tensors
from bundle_adjustment_solver_tpu_torch.ops.cuda import pose_only_batched as BK
from bundle_adjustment_solver_tpu_torch.options import (
    ConvergenceHandle,
    IterationHandle,
    Options,
    OutlierHandle,
)
from bundle_adjustment_solver_tpu_torch.utils import synthetic as port_synthetic

torch.set_num_threads(2)  # six xdist workers share the host's cores

MODES = ["mono", "stereo", "planar_mono", "planar_stereo"]
HUBER = 1.0


# ---------------------------------------------------------------------------
# Kernels (plain versions) against the JAX stats kernels
# ---------------------------------------------------------------------------


def _rodrigues(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / np.maximum(th, 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def _kernel_case(mode, B=130, P=300, seed=5):
    """float32 inputs of one kernel call: B = 130 frames and P = 300 points
    put the JAX grid at two steps on both axes (128 lanes, 256-row chunks).
    Invalid points (some behind the camera), dropped right matches, Huber
    outliers (1.5 px noise, per-frame intrinsics off by ~1%) and poses off
    the truth."""
    rng = np.random.default_rng(seed)
    planar = mode.startswith("planar")
    if planar:
        prob = port_synthetic.batched_planar_pose_only_problem(
            B, P, seed=seed, stereo=True, pixel_noise=1.5,
            drop_right_frac=0.2)
        T_cb = np.linalg.inv(prob.base_to_camera)
        R_cb = T_cb[:3, :3]
        theta = prob.theta_true + rng.normal(0, [0.02, 0.02, 0.01], (B, 3))
        c, s = np.cos(theta[:, 2]), np.sin(theta[:, 2])
        T_p = np.tile(np.eye(4), (B, 1, 1))
        T_p[:, 0, 0], T_p[:, 0, 1], T_p[:, 1, 0], T_p[:, 1, 1] = c, -s, s, c
        T_p[:, :2, 3] = theta[:, :2]
        T = T_cb @ T_p
        psi = np.stack([c, s]).astype(np.float32)
    else:
        prob = port_synthetic.batched_stereo_pose_only_problem(
            B, P, seed=seed, pixel_noise=1.5, drop_right_frac=0.2)
        T = np.linalg.inv(prob.poses_true)
        T[:, :3, :3] = _rodrigues(rng.normal(0, 0.01, (B, 3))) @ T[:, :3, :3]
        T[:, :3, 3] += rng.normal(0, 0.02, (B, 3))
        psi = None
    pts = prob.points.copy()
    valid = rng.uniform(size=(B, P)) > 0.1
    behind = ~valid & (rng.uniform(size=(B, P)) < 0.5)
    pts[behind] *= -1.0
    pix_r = prob.pixels_right
    valid_r = valid & (pix_r[..., 0] >= 0) & (pix_r[..., 1] >= 0)
    base = np.concatenate([prob.intrinsics, prob.intrinsics])
    intr = base * (1 + 0.01 * rng.normal(size=(B, 8)))
    T_rl = np.linalg.inv(prob.pose_left_to_right)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    case = dict(
        R=f32(T[:, :3, :3]), t=f32(T[:, :3, 3]), intr=f32(intr),
        pts=f32(pts), pix_l=f32(prob.pixels_left), pix_r=f32(pix_r),
        valid_l=f32(valid), valid_r=f32(valid_r), psi=psi,
        rig=f32(T_rl[:3, :4]),
    )
    if planar:
        case["rcb"] = f32(T_cb[:3, :4])
        rcbr = np.zeros((3, 4))
        rcbr[:, :3] = case["rig"][:, :3].astype(np.float64) @ R_cb
        case["rcbr"] = f32(rcbr)
    return case


def _jax_stats(mode, c):
    B, P = c["valid_l"].shape
    p_pad, b_pad = JB.plane_dims(B, P)
    pack = lambda a: JB.pack_frames_planes(jnp.asarray(a), p_pad, b_pad)
    pose12 = JB.pose_planes(jnp.asarray(c["R"]), jnp.asarray(c["t"]), b_pad)
    intr8 = JB.intr_planes([jnp.asarray(c["intr"][:, k]) for k in range(8)],
                           b_pad)
    x, y, z = pack(c["pts"])
    pul, pvl = pack(c["pix_l"])
    vl = pack(c["valid_l"])
    pur, pvr = pack(c["pix_r"])
    vr = pack(c["valid_r"])
    kw = dict(huber=HUBER, interpret=True)
    if mode == "mono":
        st = JB.batched_mono_gn_stats(pose12, intr8, x, y, z, pul, pvl, vl,
                                      **kw)
        n = 28
    elif mode == "stereo":
        st = JB.batched_stereo_gn_stats(pose12, intr8, jnp.asarray(c["rig"]),
                                        x, y, z, pul, pvl, vl, pur, pvr, vr,
                                        **kw)
        n = 28
    else:
        psi2 = jnp.zeros((2, b_pad), jnp.float32).at[:, :B].set(c["psi"])
        rcb = jnp.asarray(c["rcb"])
        if mode == "planar_mono":
            st = JB.batched_planar_mono_gn_stats(
                pose12, intr8, psi2, rcb, x, y, z, pul, pvl, vl, **kw)
        else:
            st = JB.batched_planar_stereo_gn_stats(
                pose12, intr8, psi2, rcb, jnp.asarray(c["rcbr"]),
                jnp.asarray(c["rig"]), x, y, z, pul, pvl, vl, pur, pvr, vr,
                **kw)
        n = 10
    return np.asarray(st)[:n, :B].T


def _port_stats(mode, c):
    t = lambda a: torch.from_numpy(a)
    pose12 = BK.pose_rows(t(c["R"]), t(c["t"]))
    intr8 = t(c["intr"]).T.contiguous()
    stereo = mode.endswith("stereo")
    obs = BK.obs_planes(t(c["pts"]), t(c["pix_l"]), t(c["valid_l"]),
                        t(c["pix_r"]) if stereo else None,
                        t(c["valid_r"]) if stereo else None)
    if mode == "mono":
        return BK.batched_mono_gn_stats(pose12, intr8, obs, HUBER)
    if mode == "stereo":
        return BK.batched_stereo_gn_stats(pose12, intr8, t(c["rig"]), obs,
                                          HUBER)
    psi2 = t(c["psi"])
    if mode == "planar_mono":
        return BK.batched_planar_mono_gn_stats(pose12, intr8, psi2,
                                               t(c["rcb"]), obs, HUBER)
    return BK.batched_planar_stereo_gn_stats(
        pose12, intr8, psi2, t(c["rcb"]), t(c["rcbr"]), t(c["rig"]), obs,
        HUBER)


def _hold(got, want, rtol=4e-5):
    """Each entry within rtol of its rounding scale (see the module
    docstring). Off-diagonal and gradient entries are sums of signed terms
    far larger than the entry, so their rounding is relative to the terms,
    not to the entry."""
    allowed = rtol * BK.gn_stats_rounding_scale(torch.from_numpy(want))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= allowed.numpy()).all(), float((err / allowed).max())


PLAIN = {
    "mono": BK.batched_mono_gn_stats_plain,
    "stereo": BK.batched_stereo_gn_stats_plain,
    "planar_mono": BK.batched_planar_mono_gn_stats_plain,
    "planar_stereo": BK.batched_planar_stereo_gn_stats_plain,
}
WRAPPER = {
    "mono": BK.batched_mono_gn_stats,
    "stereo": BK.batched_stereo_gn_stats,
    "planar_mono": BK.batched_planar_mono_gn_stats,
    "planar_stereo": BK.batched_planar_stereo_gn_stats,
}


@pytest.mark.parametrize("mode", MODES)
def test_stats_match_jax(mode):
    c = _kernel_case(mode)
    want = _jax_stats(mode, c)
    calls = PLAIN[mode].calls
    got = _port_stats(mode, c)
    # CPU tensors take the plain version, never a kernel.
    assert PLAIN[mode].calls == calls + 1
    assert WRAPPER[mode].launches == 0
    assert got.shape == want.shape and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(want).all()
    _hold(got, want.astype(np.float64))
    # The data reach both weight branches, and invalid points add nothing.
    assert (want[:, -1] > 0).all()


def test_wrappers_reject_other_devices():
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        BK.batched_mono_gn_stats(meta(12, 3), meta(8, 3), meta(6, 3, 5), 1.0)
    with pytest.raises(ValueError, match="host"):
        BK.batched_stereo_gn_stats(torch.zeros(12, 3), torch.zeros(8, 3),
                                   torch.zeros(3, 3), torch.zeros(9, 3, 5),
                                   1.0)


# ---------------------------------------------------------------------------
# Whole solves against the JAX package's fused batched solvers
# ---------------------------------------------------------------------------


def _solve_case(mode, B, P, seed, noise):
    if mode.startswith("planar"):
        prob = port_synthetic.batched_planar_pose_only_problem(
            B, P, seed=seed, stereo=mode == "planar_stereo",
            pixel_noise=noise, drop_right_frac=0.15)
    else:
        prob = port_synthetic.batched_stereo_pose_only_problem(
            B, P, seed=seed, pixel_noise=noise, drop_right_frac=0.15)
    arrays = dataclasses.asdict(prob)
    arrays["valid"] = np.ones((B, P), bool)
    return prob, batched_problem_tensors(arrays, "cpu")


def _args(mode, t, per_frame_intrinsics=False):
    B = t["points"].shape[0]
    intr = t["intrinsics"]
    if per_frame_intrinsics:
        intr = intr[None].repeat(B, 1)
    if mode == "mono":
        return (t["points"], t["pixels_left"], t["valid"], intr,
                t["poses_initial"])
    if mode == "stereo":
        return (t["points"], t["pixels_left"], t["pixels_right"], t["valid"],
                intr, intr, t["pose_left_to_right"], t["poses_initial"])
    chain = (t["poses_world_to_last"], t["poses_world_to_current_init"])
    if mode == "planar_mono":
        return (t["points"], t["pixels_left"], t["valid"], intr,
                t["base_to_camera"]) + chain
    return (t["points"], t["pixels_left"], t["pixels_right"], t["valid"],
            intr, intr, t["base_to_camera"], t["pose_left_to_right"]) + chain


PORT_SOLVE = {
    "mono": solve_monocular_6dof_batched,
    "stereo": solve_stereo_6dof_batched,
    "planar_mono": solve_monocular_planar3dof_batched,
    "planar_stereo": solve_stereo_planar3dof_batched,
}
JAX_SOLVE = {
    "mono": JP.solve_monocular_6dof_batched,
    "stereo": JP.solve_stereo_6dof_batched,
    "planar_mono": JP.solve_monocular_planar3dof_batched,
    "planar_stereo": JP.solve_stereo_planar3dof_batched,
}


def _options(thr, max_iter, **kw):
    return Options(
        convergence_handle=ConvergenceHandle(thr, thr),
        outlier_handle=OutlierHandle(1.0, 2.5),
        iteration_handle=IterationHandle(max_iter),
    ).replace(**kw)


def _jax_options(thr, max_iter):
    return JOptions(
        convergence_handle=JConvergence(thr, thr),
        outlier_handle=JOutlier(1.0, 2.5),
        iteration_handle=JIteration(max_iter),
        pallas="interpret",
    )


# (B, P, seed, threshold, max_iter) as in the JAX package's fused tests; the
# planar problems come from the batched generator instead of a stack of
# single-frame problems.
SOLVE_CASES = {
    "mono": (4, 120, 8, 1e-7, 40),
    "stereo": (5, 100, 3, 1e-7, 40),
    "planar_mono": (4, 2000, 10, 1e-6, 60),
    "planar_stereo": (4, 2000, 11, 1e-6, 60),
}


@pytest.mark.parametrize("mode", MODES)
def test_solve_matches_jax_fused(mode):
    B, P, seed, thr, max_iter = SOLVE_CASES[mode]
    _, t = _solve_case(mode, B, P, seed, noise=0.3)
    per_frame = mode == "mono"  # (B, 4) intrinsics, as intr_planes allows
    args = _args(mode, t, per_frame_intrinsics=per_frame)
    ref = JAX_SOLVE[mode](*[jnp.asarray(a.numpy()) for a in args],
                          _jax_options(thr, max_iter))
    got = PORT_SOLVE[mode](*args, _options(thr, max_iter), device="cpu")
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}

    assert got["success"].all() and ref["success"].all()
    np.testing.assert_allclose(got["pose"], ref["pose"], atol=3e-5)
    assert np.abs(got["num_iterations"].astype(np.int64)
                  - ref["num_iterations"]).max() <= 1
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    for k in ("mask_inlier", "mask_inlier_right"):
        assert (got[k] == ref[k]).mean() > 0.99
    ni = np.minimum(got["num_info"], ref["num_info"])
    nd = np.minimum(got["num_debug"], ref["num_debug"])
    assert ni.min() >= 2
    for b in range(B):
        np.testing.assert_allclose(got["info"][b, : ni[b], 0],
                                   ref["info"][b, : ni[b], 0], rtol=2e-4)
        np.testing.assert_allclose(got["debug_poses"][b, : nd[b]],
                                   ref["debug_poses"][b, : nd[b]], atol=3e-5)


@pytest.mark.parametrize("mode", MODES)
def test_solve_recovers_truth(mode):
    """Noise-free frames converge to the generator's truth."""
    prob, t = _solve_case(mode, B=6, P=128, seed=21, noise=0.0)
    res = PORT_SOLVE[mode](*_args(mode, t), _options(1e-7, 40),
                           device="cpu")
    truth = (prob.poses_world_to_current_true if mode.startswith("planar")
             else prob.poses_true)
    assert bool(res.success.all()) and bool(res.converged.all())
    assert bool(res.mask_inlier.all())
    assert np.abs(res.pose.numpy() - truth).max() < 1e-4


def test_history_off_gives_the_same_poses():
    _, t = _solve_case("stereo", B=3, P=64, seed=2, noise=0.3)
    args = _args("stereo", t)
    full = solve_stereo_6dof_batched(*args, _options(1e-7, 40), device="cpu")
    slim = solve_stereo_6dof_batched(
        *args, _options(1e-7, 40, record_history=False), device="cpu")
    np.testing.assert_array_equal(slim.pose.numpy(), full.pose.numpy())
    assert tuple(slim.info.shape) == (3, 1, 8)
    assert tuple(slim.debug_poses.shape) == (3, 1, 4, 4)
    assert full.info.shape[1] == 40


def test_valid_point_at_zero_depth_fails_its_frame_only():
    """The z -> 1 guard covers invalid points only: a valid point at z = 0
    makes its frame's stats non-finite, so that frame alone ends with
    success=False (the JAX package's NaN guard)."""
    _, t = _solve_case("mono", B=4, P=64, seed=6, noise=0.0)
    points = t["points"].clone()
    points[2, 5] = 0.0  # a valid point at the camera centre of the guess
    invalid = t["valid"].clone()
    invalid[1, 7] = False
    points[1, 7] = 0.0  # an invalid one there is harmless
    res = solve_monocular_6dof_batched(
        points, t["pixels_left"], invalid, t["intrinsics"],
        t["poses_initial"], _options(1e-7, 20), device="cpu")
    assert res.success.tolist() == [True, True, False, True]


@pytest.mark.parametrize("case", ["reference_masks", "per_frame_rig",
                                  "per_frame_base_to_camera"])
def test_single_frame_cases_raise(case):
    B, P = 2, 16
    if case == "per_frame_base_to_camera":
        _, t = _solve_case("planar_mono", B, P, seed=1, noise=0.0)
        args = list(_args("planar_mono", t))
        args[4] = args[4][None].repeat(B, 1, 1)
        fn, opts = solve_monocular_planar3dof_batched, _options(1e-6, 5)
    else:
        _, t = _solve_case("stereo", B, P, seed=1, noise=0.0)
        args = list(_args("stereo", t))
        opts = _options(1e-6, 5)
        if case == "per_frame_rig":
            args[6] = args[6][None].repeat(B, 1, 1)
        else:
            opts = opts.replace(outlier_mask="reference")
        fn = solve_stereo_6dof_batched
    with pytest.raises(NotImplementedError, match="single-frame"):
        fn(*args, opts, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_entry_points_need_a_device_without_a_card(mode):
    _, t = _solve_case(mode, B=2, P=16, seed=1, noise=0.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT_SOLVE[mode](*_args(mode, t), _options(1e-6, 5))


@pytest.mark.parametrize("kind", ["stereo", "planar_mono", "planar_stereo"])
def test_generators_bit_identical(kind):
    if kind == "stereo":
        kw = dict(num_frames=7, points_per_frame=33, seed=4, pixel_noise=0.5)
        a = port_synthetic.batched_stereo_pose_only_problem(**kw)
        b = jax_synthetic.batched_stereo_pose_only_problem(**kw)
    else:
        kw = dict(num_frames=7, points_per_frame=33, seed=4, pixel_noise=0.5,
                  stereo=kind == "planar_stereo")
        a = port_synthetic.batched_planar_pose_only_problem(**kw)
        b = jax_synthetic.batched_planar_pose_only_problem(**kw)
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        if db[k] is None:
            assert da[k] is None
        else:
            np.testing.assert_array_equal(da[k], db[k])


def test_lie_and_projection_helpers_match_jax():
    """The small pieces the solvers share with the JAX package: compose,
    the planar maps, the row-wise SE(3) step and the final-mask projection."""
    from bundle_adjustment_solver_tpu.ops import lie as jax_lie
    from bundle_adjustment_solver_tpu.ops import projection as jax_proj
    from bundle_adjustment_solver_tpu_torch.ops import lie as port_lie
    from bundle_adjustment_solver_tpu_torch.ops import projection as port_proj

    rng = np.random.default_rng(12)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    R1, t1, R2, t2 = f(5, 3, 3), f(5, 3), f(5, 3, 3), f(5, 3)
    want = jax_lie.compose(*map(jnp.asarray, (R1, t1, R2, t2)))
    got = port_lie.compose(*map(torch.from_numpy, (R1, t1, R2, t2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    theta = f(7, 3)
    for g, w in zip(port_lie.planar_to_se3(torch.from_numpy(theta)),
                    jax_lie.planar_to_se3(jnp.asarray(theta))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    R, t = jax_lie.planar_to_se3(jnp.asarray(theta))
    np.testing.assert_allclose(
        port_lie.se3_to_planar(torch.tensor(np.asarray(R)),
                               torch.tensor(np.asarray(t))).numpy(),
        np.asarray(jax_lie.se3_to_planar(R, t)), atol=1e-6)

    pose12, delta = f(12, 9), 0.1 * f(6, 9)
    delta[3:, 0] = 0.0  # a pure translation takes the Taylor branches
    np.testing.assert_allclose(
        BK.add_front_se3_rows(torch.from_numpy(pose12),
                              torch.from_numpy(delta)).numpy(),
        np.asarray(JB.add_front_se3_rows(jnp.asarray(pose12),
                                         jnp.asarray(delta))),
        rtol=1e-5, atol=1e-6)

    X, pix = f(40, 3) + np.float32([0, 0, 3]), 300 * f(40, 2)
    X[0, 2] = 0.0  # no z guard: inf / NaN as in the JAX package
    intr = (500.0, 510.0, 320.0, 240.0)
    got = port_proj.residual_and_weight(torch.from_numpy(X),
                                        torch.from_numpy(pix), *intr, 1.0)
    want = jax_proj.residual_and_weight(jnp.asarray(X), jnp.asarray(pix),
                                        *intr, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
