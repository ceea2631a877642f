"""Pinhole projection and the Manhattan-Huber weight.

Counterpart of `residual_and_weight` in the JAX package's
`ops/projection.py`, the piece the batched pose-only solvers use for their
final inlier masks. It has no z guard: a point at z = 0 projects to inf or
NaN, and a mask `valid & (manhattan < threshold)` drops it.
"""

from __future__ import annotations

import torch


def residual_and_weight(
    X_cam: torch.Tensor,  # (..., 3)
    pixel: torch.Tensor,  # (..., 2)
    fx,
    fy,
    cx,
    cy,
    huber_delta: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project, take the residual, and compute the Manhattan-Huber weight.

    Returns (residual (..., 2), weight (...), manhattan (...)); `manhattan`
    is the |r_u|+|r_v| outlier-gate statistic the reference thresholds
    against (pose-only cpp:1404-1406: `error_nonweighted`). The intrinsics
    are scalars or tensors that broadcast against X_cam[..., 0].
    """
    inv_z = 1.0 / X_cam[..., 2]
    u = fx * X_cam[..., 0] * inv_z + cx
    v = fy * X_cam[..., 1] * inv_z + cy
    r = torch.stack([u, v], dim=-1) - pixel
    manhattan = torch.abs(r[..., 0]) + torch.abs(r[..., 1])
    weight = torch.where(
        manhattan > huber_delta, huber_delta / manhattan,
        torch.ones_like(manhattan),
    )
    return r, weight, manhattan
