"""Pieces of the full-BA solver that the point-major engine shares.

Counterpart of the parts of the JAX package's `solvers/full_ba.py` that
`solvers/full_ba_pm.py` imports: the result container `FullBAState`, the
fixed Gauss-Newton damping `_GN_LAMBDA`, and the inner-CG tolerance policy
(`_cg_tolerance`, `_cg_tolerance_from_norm`). The observation-table engine
itself is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..options import Options

# Fixed damping of the reference's plain Gauss-Newton modes (pose-only
# cpp:57; the refactor's GN branch keeps LM's evolving lambda -- the small
# constant is pinned instead, which is strictly better conditioned).
_GN_LAMBDA = 1e-5


class FullBAState(NamedTuple):
    """Result of a full-BA solve (tensors on the solve's device)."""

    poses_world_to_camera: torch.Tensor  # (N, 4, 4) user-facing, unscaled
    points: torch.Tensor  # (M, 3) unscaled
    converged: torch.Tensor  # () bool
    num_iterations: torch.Tensor  # () int32
    info: torch.Tensor  # (max_iter, INFO_NUM_COLS)
    num_info: torch.Tensor  # () int32
    final_cost: torch.Tensor  # () reference-metric cost (scaled units)
    final_rmse_px: torch.Tensor  # () unscaled reprojection RMSE in pixels


def _cg_tolerance(opts: Options, rhs, rhs_norm_prev, eta_prev):
    """Per-LM-iteration inner-CG relative tolerance.

    'fixed': the constant Options.cg_tolerance (on ||r||^2/||rhs||^2).
    'ew': Eisenstat-Walker choice 2 (eta_k = gamma (||rhs_k||/||rhs_{k-1}||)^2
    with the gamma eta_{k-1}^2 safeguard, clamped to
    [cg_forcing_min, cg_forcing_max]); the first LM iteration uses the max.
    Returns (tol, eta, rhs_norm) with tol = eta^2 so the PCG's
    squared-residual test stops at ||r|| <= eta ||rhs||.
    """
    return _cg_tolerance_from_norm(
        opts, torch.sqrt(torch.sum(rhs * rhs)), rhs_norm_prev, eta_prev
    )


def _cg_tolerance_from_norm(opts: Options, rhs_norm, rhs_norm_prev,
                            eta_prev):
    """`_cg_tolerance` on a precomputed ||rhs|| (0-dim tensors in, 0-dim
    tensors out, all on the device of `rhs_norm`)."""
    full = lambda v: torch.full_like(rhs_norm, v)
    if getattr(opts, "cg_forcing", "fixed") != "ew":
        return full(opts.cg_tolerance), full(0.0), rhs_norm
    gamma = 0.9
    eta_raw = gamma * (rhs_norm / torch.clamp_min(rhs_norm_prev, 1e-30)) ** 2
    guard = gamma * eta_prev * eta_prev
    eta = torch.where(guard > 0.1, torch.maximum(eta_raw, guard), eta_raw)
    eta = torch.where(rhs_norm_prev > 0.0, eta, full(opts.cg_forcing_max))
    eta = torch.clamp(eta, opts.cg_forcing_min, opts.cg_forcing_max)
    return eta * eta, eta, rhs_norm
