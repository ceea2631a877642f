"""Problem containers: `FinalizedProblem` and `ProblemShape`.

Counterparts of the JAX package's containers of the same names, with the
same fields. The builder class and `finalized_from_arrays` are not ported
yet; the point-major entry point (`solvers.full_ba_pm.pm_problem_from_arrays`)
fills these containers directly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .camera import CameraRig


class FinalizedProblem(NamedTuple):
    """Static-shape tensors for one full-BA problem.

    Poses are stored as the solver-internal T_jw = world -> rig-reference
    transform (the INVERSE of the user-registered pose, cpp:96), with
    translations pre-scaled; points and pixels pre-scaled.
    """

    rig: CameraRig
    R_cw: torch.Tensor  # (N, 3, 3)
    t_cw: torch.Tensor  # (N, 3) scaled
    points: torch.Tensor  # (M, 3) scaled
    obs_cam: torch.Tensor  # (O,) int32
    obs_pose: torch.Tensor  # (O,) int32 index into N
    obs_point: torch.Tensor  # (O,) int32 index into M
    obs_pixel: torch.Tensor  # (O, 2) scaled
    obs_pose_opt: torch.Tensor  # (O,) int32 in [0, N_opt]; N_opt = fixed sentinel
    obs_point_opt: torch.Tensor  # (O,) int32 in [0, M_opt]
    obs_valid: torch.Tensor  # (O,) bool (False for padding rows)
    opt_pose_idx: torch.Tensor  # (N_opt,) int64: optimization slot -> pose index
    opt_point_idx: torch.Tensor  # (M_opt,) int64


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """Static (hashable) problem dimensions."""

    num_poses: int
    num_points: int
    num_observations: int
    num_opt_poses: int
    num_opt_points: int
    num_cameras: int
    scale: float

    @property
    def num_fixed_poses(self) -> int:
        return self.num_poses - self.num_opt_poses

    @property
    def num_fixed_points(self) -> int:
        return self.num_points - self.num_opt_points
