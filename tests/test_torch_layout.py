"""The port's point-major layout build against the JAX package's builder.

Both builders get the same host arrays (made with numpy from a seed); the
JAX builder is called directly, so its block padding is the `pad_blocks_to`
given here and nothing else. Integer planes must be bit-equal and float
planes equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu.models import layout as jax_layout
from bundle_adjustment_solver_tpu_torch.models import layout as port_layout
from bundle_adjustment_solver_tpu_torch.utils.synthetic import corridor_ba_problem

torch.set_num_threads(2)  # six xdist workers share the host's cores

SCALE = 0.01


def _inputs(num_fixed_points=0, dropout=0.0, loop_closure=False):
    prob = corridor_ba_problem(num_poses=30, num_points=1500, window=5, seed=4)
    keep = np.ones(prob.obs_pose.shape[0], bool)
    if dropout:
        keep = np.random.default_rng(7).random(keep.shape[0]) > dropout
    obs_pose = prob.obs_pose.copy()
    if loop_closure:
        # Rewire a few observations far along the trajectory (widens P).
        sel = np.random.default_rng(3).random(obs_pose.shape[0]) < 0.01
        obs_pose[sel] = (obs_pose[sel] + 15) % 30
        tri = (prob.obs_point.astype(np.int64) * 60 + obs_pose * 2
               + prob.obs_camera)
        _, first = np.unique(tri, return_index=True)
        uniq = np.zeros_like(keep)
        uniq[first] = True
        keep &= uniq
    N, M = 30, 1500
    fixed_pose = np.zeros(N, bool)
    fixed_pose[prob.fixed_pose_ids] = True
    n_opt = int((~fixed_pose).sum())
    pose_opt_of = np.full(N, n_opt, np.int32)
    pose_opt_of[~fixed_pose] = np.arange(n_opt, dtype=np.int32)
    point_is_opt = np.ones(M, bool)
    point_is_opt[:num_fixed_points] = False
    return (
        obs_pose[keep].astype(np.int32),
        prob.obs_point[keep].astype(np.int32),
        prob.obs_camera[keep].astype(np.int32),
        prob.obs_pixel[keep] * SCALE,
        prob.points_initial * SCALE,
        pose_opt_of,
        point_is_opt,
    ), n_opt


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(num_fixed_points=17),
        dict(dropout=0.3),
        dict(loop_closure=True),
        dict(pad_blocks_to=2),
        dict(block_points=256, num_fixed_points=40),
    ],
)
def test_build_point_major_matches_jax(case):
    case = dict(case)
    pad = case.pop("pad_blocks_to", 1)
    bm = case.pop("block_points", 128)
    args, n_opt = _inputs(**case)
    kw = dict(num_opt_poses=n_opt, block_points=bm, pad_blocks_to=pad)
    ref = jax_layout.build_point_major(*args, 2, SCALE, **kw)
    got = port_layout.build_point_major(*args, 2, SCALE, device="cpu", **kw)
    assert ref is not None and got is not None
    (pm_j, ps_j), (pm_p, ps_p) = ref, got
    # P <= 256 here, where the JAX package's window rounding does not apply.
    assert ps_j.window <= 256
    assert dataclasses.asdict(ps_p) == dataclasses.asdict(ps_j)
    for name in pm_j._fields:
        a = np.asarray(getattr(pm_j, name))
        b = getattr(pm_p, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=f"plane {name} differs")


def test_build_point_major_refuses_what_the_jax_builder_refuses():
    args, n_opt = _inputs()
    kw = dict(num_opt_poses=n_opt, block_points=128)
    assert port_layout.build_point_major(
        *args, 2, SCALE, max_slots=2, device="cpu", **kw) is None
    assert jax_layout.build_point_major(*args, 2, SCALE, max_slots=2, **kw) is None
    # A duplicate (landmark, pose, camera) observation has no plane cell.
    dup = [np.concatenate([a, a[:1]]) for a in args[:4]] + list(args[4:])
    assert port_layout.build_point_major(*dup, 2, SCALE, device="cpu", **kw) is None
    assert jax_layout.build_point_major(*dup, 2, SCALE, **kw) is None
