"""Fused pose-side PCG step for the point-major reduced-system solve.

Counterpart of the JAX package's `ops/pallas/cg_step.py`. One kernel
(`csrc/cg_step.cu`) performs the pose-side algebra of a PCG iteration on
the reduced camera system S x = rhs (the solve the reference does directly
at core/full_bundle_adjustment_solver.cpp:890-908):

    Sp    = A p - corr            (A in flat tri layout, corr from the
                                   landmark-side matvec kernel)
    alpha = rz / (p . Sp)
    x'    = x + alpha p
    r'    = r - alpha Sp
    z     = M^-1 r'               (block-Jacobi, tri layout)
    rz'   = r' . z
    beta  = rz' / rz
    p'    = z + beta p
    rr    = r' . r'               (for the termination test)

Layout: PLANE form -- components along rows, poses along the row, `Np`
padded to a multiple of LANES -- so each of the 21 triangle components of A
/ M^-1 and the 6 vector components is one contiguous row. `AP` stacks the
damped-A planes (rows 0:21) over the preconditioner planes (rows 21:42);
both are constant across one CG solve. Padded lanes are zero in every
operand and stay zero through the iteration, so the reductions are exact.

`cg_pose_step` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; `cg_pose_step.launches` and
`cg_pose_step_plain.calls` count each.
"""

from __future__ import annotations

import ctypes

import torch

from ..sym6 import _IDX
from . import _build

# Poses are padded to a multiple of this, as in the JAX package, so the
# plane tensors of the two packages have the same shapes.
LANES = 128

# The JAX package routes problems above this many optimizable poses to the
# unfused PCG loop (its one-block kernel keeps every plane in on-chip
# memory). The same routing is kept so both packages run the same loop for
# the same problem; this package's one-block kernel strides over the poses
# and has no such memory bound.
MAX_FUSED_POSES = 16_384

_SIGNATURES = {"ba_cg_step": [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]}


def padded_poses(n_opt: int) -> int:
    """Lane-padded pose count for the plane layout."""
    return ((n_opt + LANES - 1) // LANES) * LANES


def to_planes(v, Np):
    """(n, 6) -> zero-padded (6, Np) plane form."""
    n = v.shape[0]
    out = torch.zeros((6, Np), dtype=torch.float32, device=v.device)
    out[:, :n] = v.T
    return out


def plane_sym6_matvec(T, v):
    """y = T @ v on planes: T (21, Np) tri components, v (6, Np)."""
    rows = []
    for a in range(6):
        acc = None
        for b in range(6):
            key = (a, b) if a <= b else (b, a)
            term = T[_IDX[key]] * v[b]
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows)


def _dot6(u, v):
    acc = None
    for a in range(6):
        s = torch.sum(u[a] * v[a])
        acc = s if acc is None else acc + s
    return acc


def cg_pose_step_plain(AP, corr, x, r, p, rz):
    """Plain version of the fused step: (x', r', p', alpha, rz', rr)."""
    cg_pose_step_plain.calls += 1
    Sp = plane_sym6_matvec(AP[:21], p) - corr
    alpha = rz / torch.clamp_min(_dot6(p, Sp), 1e-30)
    xo = x + alpha * p
    ro = r - alpha * Sp
    z = plane_sym6_matvec(AP[21:], ro)
    rz_new = _dot6(ro, z)
    beta = rz_new / torch.clamp_min(rz, 1e-30)
    po = z + beta * p
    return xo, ro, po, alpha, rz_new, _dot6(ro, ro)


cg_pose_step_plain.calls = 0


def cg_pose_step_rounding_scale(AP, corr, x, r, p, rz, out):
    """Float32 rounding scale of each output of the step, element by element,
    for holding one evaluation of it against another.

    The outputs cancel: once the preconditioner is good, r' = r - alpha Sp is
    orders of magnitude smaller than its terms, and p', rz' and rr inherit
    that. Each scale is the first-order bound of float32 rounding: the summed
    magnitudes of the terms the output is formed from, with what the
    rounding of alpha (from p . Sp) and of beta (from rz') carries in. Two
    correct evaluations in any order differ by a few float32 ulps of it; a
    wrong output (r' zeroed, rr doubled) by orders of magnitude more. `out`
    is one evaluation (x', r', p', alpha, rz', rr)."""
    _, ro, _, alpha, _, _ = out
    a, rz_abs = alpha.abs(), rz.abs().clamp_min(1e-30)
    sp = plane_sym6_matvec(AP[:21].abs(), p.abs()) + corr.abs()
    # alpha = rz / (p . Sp) and p . Sp = rz / alpha: its relative rounding.
    kappa = _dot6(p.abs(), sp) * a / rz_abs
    x_s = x.abs() + a * (1 + kappa) * p.abs()
    r_s = r.abs() + a * (1 + kappa) * sp
    z = plane_sym6_matvec(AP[21:], ro)
    z_s = plane_sym6_matvec(AP[21:].abs(), r_s)
    rz_s = _dot6(ro.abs(), z_s) + _dot6(r_s, z.abs())
    p_s = z_s + p.abs() * (rz_s / rz_abs)  # beta = rz' / rz
    return x_s, r_s, p_s, a * kappa, rz_s, 2 * _dot6(ro.abs(), r_s)


def cg_pose_step(AP, corr, x, r, p, rz):
    """One fused PCG iteration on the pose planes.

    AP (42, Np) float32: damped-A tri planes stacked over preconditioner tri
    planes. corr/x/r/p (6, Np) float32. rz: 0-dim float32 tensor on the
    same device. Returns (x', r', p', alpha, rz', rr), the scalars as 0-dim
    tensors that stay on the device."""
    dev = AP.device
    Np = AP.shape[1]
    for name, t, shape in (("AP", AP, (42, Np)), ("corr", corr, (6, Np)),
                           ("x", x, (6, Np)), ("r", r, (6, Np)),
                           ("p", p, (6, Np)), ("rz", rz, ())):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}")
    if dev.type == "cpu":
        return cg_pose_step_plain(AP, corr, x, r, p, rz)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    xo = torch.empty_like(x)
    ro = torch.empty_like(r)
    po = torch.empty_like(p)
    sc = torch.empty((3,), dtype=torch.float32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _build.library("cg_step", _SIGNATURES).ba_cg_step(
        ptr(AP), ptr(corr), ptr(x), ptr(r), ptr(p), ptr(rz), ptr(xo),
        ptr(ro), ptr(po), ptr(sc), Np,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    _build.check(err, "ba_cg_step")
    cg_pose_step.launches += 1
    return xo, ro, po, sc[0], sc[1], sc[2]


cg_pose_step.launches = 0
