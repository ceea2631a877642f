"""Batched SE(3) operations on torch tensors.

Counterpart of the part of the JAX package's `ops/lie.py` that the
point-major and batched pose-only solvers use: `se3_exp`, `compose`,
`compose_flat`, `inverse_se3` and the planar (x, y, psi) maps, with the
Taylor guards they need (reference: utility/geometry_library.h:10-55
and the solver-local exponentials, core/full_bundle_adjustment_solver.cpp:
1046-1102). Inputs may carry arbitrary leading batch dimensions. The 3x3
products run in full float32: `torch.backends.cuda.matmul.allow_tf32`
stays False (PyTorch's default), which the port never changes.
"""

from __future__ import annotations

import torch

# Small-angle cutoff: below this theta**2, use Taylor series.  f32-safe.
_SMALL_ANGLE_SQ = 1e-12


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x
    (geometry::skewMat, utility/geometry_library.cpp:6-21)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _sin_theta_over_theta(theta_sq: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with Taylor fallback 1 - t^2/6."""
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)


def _one_minus_cos_over_theta_sq(theta_sq: torch.Tensor) -> torch.Tensor:
    """(1-cos t)/t^2 with Taylor fallback 1/2 - t^2/24."""
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe)
    return torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe
    )


def _theta_minus_sin_over_theta_cubed(theta_sq: torch.Tensor) -> torch.Tensor:
    """(t - sin t)/t^3 with Taylor fallback 1/6 - t^2/120."""
    small = theta_sq < _SMALL_ANGLE_SQ
    safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe)
    return torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (safe * theta),
    )


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6) twist [v; w] -> ((..., 3, 3) R, (..., 3) t).

    Twist layout matches the reference solvers: translation first, rotation
    last (core/full_bundle_adjustment_solver.cpp:1046-1102).
    """
    v = xi[..., :3]
    w = xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    wx = skew(w)
    wx2 = torch.matmul(wx, wx)
    a = _sin_theta_over_theta(theta_sq)[..., None, None]
    b = _one_minus_cos_over_theta_sq(theta_sq)[..., None, None]
    c = _theta_minus_sin_over_theta_cubed(theta_sq)[..., None, None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(wx.shape)
    R = eye + a * wx + b * wx2
    V = eye + b * wx + c * wx2
    t = torch.matmul(V, v.unsqueeze(-1)).squeeze(-1)
    return R, t


def compose(
    R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor, t2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R1, t1) * (R2, t2): first apply 2, then 1."""
    R = torch.matmul(R1, R2)
    t = torch.matmul(R1, t2.unsqueeze(-1)).squeeze(-1) + t1
    return R, t


def compose_flat(
    dR: torch.Tensor, dt: torch.Tensor, R9: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dR, dt) * (R, t) with the right-hand pose in flat row-major
    9-column form, the layout of the point-major pose table (R in columns
    0:9, t in 9:12). Computes (dR @ R, dR @ t + dt) column by column in
    exact f32 multiplies.

    dR (..., 3, 3), dt (..., 3), R9 (..., 9), t (..., 3) -> ((..., 9),
    (..., 3)).
    """
    d = [[dR[..., i, k] for k in range(3)] for i in range(3)]
    Rn = torch.stack(
        [
            d[i][0] * R9[..., j] + d[i][1] * R9[..., 3 + j]
            + d[i][2] * R9[..., 6 + j]
            for i in range(3)
            for j in range(3)
        ],
        dim=-1,
    )
    tn = torch.stack(
        [
            d[i][0] * t[..., 0] + d[i][1] * t[..., 1] + d[i][2] * t[..., 2]
            + dt[..., i]
            for i in range(3)
        ],
        dim=-1,
    )
    return Rn, tn


def inverse_se3(
    R: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse rigid transform: (R^T, -R^T t)
    (geometry::inverseSE3, utility/geometry_library.cpp:721-737)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.matmul(Rt, t.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Planar (x, y, yaw) parameterization used by the 3-DoF pose-only solvers
# (core/pose_only_bundle_adjustment_solver.cpp:449-547)
# ---------------------------------------------------------------------------


def planar_to_se3(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) planar params (x, y, psi) -> SE(3) with rotation about +z."""
    x, y, psi = theta[..., 0], theta[..., 1], theta[..., 2]
    c, s = torch.cos(psi), torch.sin(psi)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    R = torch.stack(rows, dim=-2)
    t = torch.stack([x, y, zero], dim=-1)
    return R, t


def se3_to_planar(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Extract (x, y, psi) from an (approximately) planar SE(3) transform.

    psi is read from the first column of R as atan2(R10, R00), matching the
    reference prior extraction (core/pose_only_bundle_adjustment_solver.cpp:456-460).
    """
    psi = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([t[..., 0], t[..., 1], psi], dim=-1)
