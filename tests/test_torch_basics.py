"""The PyTorch port's framework-free pieces against the JAX package.

Seeded generator arrays, options, the SE(3) and flat sym6 algebra (float32),
the package's import boundary (no JAX), and the device rule of the entry
points. Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundle_adjustment_solver_tpu import options as jax_options
from bundle_adjustment_solver_tpu.ops import lie as jax_lie
from bundle_adjustment_solver_tpu.ops import sym6 as jax_sym6
from bundle_adjustment_solver_tpu.utils import synthetic as jax_synthetic
from bundle_adjustment_solver_tpu_torch import options as port_options
from bundle_adjustment_solver_tpu_torch.ops import lie as port_lie
from bundle_adjustment_solver_tpu_torch.ops import sym6 as port_sym6
from bundle_adjustment_solver_tpu_torch.utils import synthetic as port_synthetic

torch.set_num_threads(2)  # six xdist workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(num_poses=40, num_points=3000, window=6, seed=123),
        dict(num_poses=25, num_points=700, window=4, seed=9, pixel_noise=0.5,
             num_fixed_poses=3),
    ],
)
def test_corridor_generator_is_bit_identical(kwargs):
    a = jax_synthetic.corridor_ba_problem(**kwargs)
    b = port_synthetic.corridor_ba_problem(**kwargs)
    for field in dataclasses.fields(a):
        if field.name == "cameras":
            for ca, cb in zip(a.cameras, b.cameras):
                assert (ca.fx, ca.fy, ca.cx, ca.cy) == (cb.fx, cb.fy, cb.cx, cb.cy)
                np.testing.assert_array_equal(ca.R_cam_from_ref, cb.R_cam_from_ref)
                np.testing.assert_array_equal(ca.t_cam_from_ref, cb.t_cam_from_ref)
            continue
        va, vb = getattr(a, field.name), getattr(b, field.name)
        assert va.dtype == vb.dtype, field.name
        np.testing.assert_array_equal(va, vb, err_msg=field.name)


def test_options_defaults_match_field_by_field():
    a, b = jax_options.Options(), port_options.Options()
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for name in fa:
        va, vb = fa[name], fb[name]
        if dataclasses.is_dataclass(va):
            assert dataclasses.asdict(va) == dataclasses.asdict(vb), name
        elif isinstance(va, jax_options.SolverType):
            assert va.value == vb.value, name
        else:
            assert va == vb, name


def _twists(rng, n):
    xi = rng.normal(0.0, 0.3, (n, 6))
    xi[: n // 4, 3:] *= 1e-8  # small angles take the Taylor branches
    xi[n // 4 : n // 2, 3:] = 0.0
    return xi.astype(np.float32)


def test_se3_exp_matches_float32():
    xi = _twists(np.random.default_rng(0), 64)
    Rj, tj = jax_lie.se3_exp(jnp.asarray(xi))
    Rp, tp = port_lie.se3_exp(torch.from_numpy(xi))
    # Float32 products of O(1) terms in another order: a few ulps.
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=2e-6)


def test_compose_flat_and_inverse_match_float32():
    rng = np.random.default_rng(1)
    dR, dt = jax_lie.se3_exp(jnp.asarray(_twists(rng, 32)))
    R, t = jax_lie.se3_exp(jnp.asarray(_twists(rng, 32)))
    R9 = np.array(R).reshape(32, 9)
    Rj, tj = jax_lie.compose_flat(dR, dt, jnp.asarray(R9), t)
    Rp, tp = port_lie.compose_flat(
        torch.from_numpy(np.array(dR)), torch.from_numpy(np.array(dt)),
        torch.from_numpy(R9), torch.from_numpy(np.array(t)),
    )
    # Same elementwise float32 expression in both packages.
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=1e-6)
    Ri_j, ti_j = jax_lie.inverse_se3(R, t)
    Ri_p, ti_p = port_lie.inverse_se3(
        torch.from_numpy(np.array(R)), torch.from_numpy(np.array(t))
    )
    np.testing.assert_array_equal(Ri_p.numpy(), np.asarray(Ri_j))
    np.testing.assert_allclose(ti_p.numpy(), np.asarray(ti_j), rtol=0, atol=1e-6)


def _spd_tri(rng, n):
    G = rng.normal(size=(n, 6, 6))
    A = G @ np.transpose(G, (0, 2, 1)) + 6.0 * np.eye(6)
    return np.stack([A[:, a, b] for (a, b) in port_sym6._TRI6], 1).astype(
        np.float32
    )


def test_sym6_component_order_matches():
    assert port_sym6._TRI6 == jax_sym6._TRI6
    assert port_sym6._IDX == jax_sym6._IDX
    assert port_sym6.DIAG_IDX == jax_sym6.DIAG_IDX


@pytest.mark.parametrize("op", ["matvec", "damp", "inverse"])
def test_sym6_ops_match_float32(op):
    rng = np.random.default_rng(2)
    Atri = _spd_tri(rng, 50)
    if op == "matvec":
        x = rng.normal(size=(50, 6)).astype(np.float32)
        want = jax_sym6.tri6_matvec(jnp.asarray(Atri), jnp.asarray(x))
        got = port_sym6.tri6_matvec(torch.from_numpy(Atri), torch.from_numpy(x))
        rtol = 1e-6  # six products summed in the same order
    elif op == "damp":
        want = jax_sym6.tri6_damp(jnp.asarray(Atri), 0.37)
        got = port_sym6.tri6_damp(torch.from_numpy(Atri), 0.37)
        rtol = 0.0
    else:
        want = jax_sym6.inverse_tri6(jnp.asarray(Atri))
        got = port_sym6.inverse_tri6(torch.from_numpy(Atri))
        # Two closed-form 3x3 inverses chained: rounding grows with the
        # blocks' condition numbers (well conditioned here).
        rtol = 1e-5
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max()
    )


def test_port_imports_no_jax():
    """Every module of the port imports with JAX and the JAX package
    blocked, in a fresh interpreter."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bundle_adjustment_solver_tpu'] = None\n"
        "import bundle_adjustment_solver_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no device given and no CUDA card, the entry points raise."""
    from bundle_adjustment_solver_tpu_torch import pm_problem_from_arrays
    from bundle_adjustment_solver_tpu_torch.convert import from_jax_numpy
    from bundle_adjustment_solver_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = port_synthetic.corridor_ba_problem(num_poses=8, num_points=50,
                                              window=3, seed=1)
    args = (prob.cameras, prob.poses_initial, prob.points_initial,
            prob.obs_camera, prob.obs_pose, prob.obs_point, prob.obs_pixel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm_problem_from_arrays(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_numpy({}, {}, {}, np.eye(3)[None], np.zeros((1, 3)), None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert pm_problem_from_arrays(*args, device="cpu") is not None
