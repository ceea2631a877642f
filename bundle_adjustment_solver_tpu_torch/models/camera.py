"""Camera models on torch tensors.

Counterpart of the JAX package's `models/camera.py` (`Camera`, `stereo_rig`,
`CameraRig.from_cameras`). Re-design of the reference camera types
(`_BA_Camera`, core/full_bundle_adjustment_solver.h:92-107): pinhole
intrinsics (fx, fy, cx, cy) plus a rigid extrinsic that maps points in the
rig reference (cam0) frame into this camera's frame. Cameras are packed into
a `CameraRig` struct of tensors (K cameras).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    """A single pinhole camera in a (possibly multi-camera) rig.

    ``R_cam_from_ref`` / ``t_cam_from_ref`` map points from the rig-reference
    (cam0) frame to this camera's frame: ``X_cam = R @ X_ref + t`` (the
    reference's `pose_this_to_cam0`, core/full_bundle_adjustment_solver.h:100).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    R_cam_from_ref: np.ndarray | None = None  # (3, 3); identity if None
    t_cam_from_ref: np.ndarray | None = None  # (3,); zeros if None

    def __post_init__(self):
        if self.R_cam_from_ref is None:
            self.R_cam_from_ref = np.eye(3)
        if self.t_cam_from_ref is None:
            self.t_cam_from_ref = np.zeros(3)
        self.R_cam_from_ref = np.asarray(self.R_cam_from_ref, dtype=np.float64)
        self.t_cam_from_ref = np.asarray(self.t_cam_from_ref, dtype=np.float64)


def stereo_rig(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    baseline: float,
) -> tuple[Camera, Camera]:
    """The canonical horizontal stereo pair of the reference tests
    (test/test_ba.cpp:79-98): identical intrinsics, right camera offset by
    ``baseline`` along +x of the left camera, so
    ``X_right = X_left - [baseline, 0, 0]``."""
    left = Camera(fx, fy, cx, cy)
    right = Camera(
        fx, fy, cx, cy, np.eye(3), np.array([-baseline, 0.0, 0.0])
    )
    return left, right


class CameraRig(NamedTuple):
    """K cameras packed as a struct of tensors. Intrinsics and extrinsic
    translations may be pre-scaled by the problem's scale conditioner
    (reference: AddCamera, core/full_bundle_adjustment_solver.cpp:72-85)."""

    fx: torch.Tensor  # (K,)
    fy: torch.Tensor  # (K,)
    cx: torch.Tensor  # (K,)
    cy: torch.Tensor  # (K,)
    R_cam_from_ref: torch.Tensor  # (K, 3, 3)
    t_cam_from_ref: torch.Tensor  # (K, 3)

    @staticmethod
    def from_cameras(
        cameras: Sequence[Camera],
        scale: float = 1.0,
        dtype=torch.float32,
        device: torch.device | str = "cpu",
    ) -> "CameraRig":
        """Pack cameras, applying the scale conditioner to fx/fy/cx/cy and the
        extrinsic translation exactly as the reference does at AddCamera time
        (core/full_bundle_adjustment_solver.cpp:74-79). The products are
        taken in float64 and rounded once, as the JAX package does."""

        def t(values):
            return torch.as_tensor(
                np.asarray(values, np.float64), dtype=dtype, device=device
            )

        return CameraRig(
            fx=t([c.fx * scale for c in cameras]),
            fy=t([c.fy * scale for c in cameras]),
            cx=t([c.cx * scale for c in cameras]),
            cy=t([c.cy * scale for c in cameras]),
            R_cam_from_ref=t(np.stack([c.R_cam_from_ref for c in cameras])),
            t_cam_from_ref=t(
                np.stack([c.t_cam_from_ref * scale for c in cameras])
            ),
        )

    @property
    def num_cameras(self) -> int:
        return self.fx.shape[0]
