"""Seeded synthetic problem generators (numpy).

Counterpart of the JAX package's `utils/synthetic.py`, holding the corridor
generator of the point-major flagship problem. The same seed gives
bit-identical arrays in both packages: this module repeats the JAX
package's numpy arithmetic operation for operation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.camera import stereo_rig

# Observation-chunk size of corridor_ba_problem's projection pass: bounds
# the per-observation gather temporaries (~420 MB/chunk of f64) without
# changing any value (the pass is elementwise per observation row).
_PROJECTION_CHUNK = 2_000_000


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclasses.dataclass
class StereoBAProblem:
    """A full stereo BA problem in builder-ready form."""

    cameras: list  # [Camera] (left, right)
    poses_true: np.ndarray  # (N, 4, 4) true T_wc (world<-ref-camera)
    poses_initial: np.ndarray  # (N, 4, 4) perturbed T_wc
    points_true: np.ndarray  # (M, 3)
    points_initial: np.ndarray  # (M, 3) perturbed
    fixed_pose_ids: np.ndarray  # (F,) indices of gauge-fixed poses
    obs_camera: np.ndarray  # (O,) camera index per observation
    obs_pose: np.ndarray  # (O,) pose index
    obs_point: np.ndarray  # (O,) point index
    obs_pixel: np.ndarray  # (O, 2)


def corridor_ba_problem(
    num_poses: int,
    num_points: int,
    window: int = 6,
    seed: int = 0,
    point_error: float = 0.3,
    pose_translation_error: float = 0.05,
    pixel_noise: float = 0.0,
    fx: float = 525.0,
    fy: float = 525.0,
    cx: float = 320.0,
    cy: float = 240.0,
    baseline: float = 0.12,
    num_fixed_poses: int = 2,
) -> StereoBAProblem:
    """Scalable 'corridor' stereo BA generator, fully vectorized.

    The camera travels along +y looking at a wall at x = 5 (the viewing
    geometry of the reference's test_ba.cpp with bounded co-visibility):
    landmark i is anchored to a pose and observed by `window` consecutive
    poses through both cameras, so #observations = 2 * window * num_points
    independent of trajectory length. At 10k poses and 1M landmarks this is
    the flagship problem (12M observations).
    """
    rng = np.random.default_rng(seed)
    left, right = stereo_rig(fx, fy, cx, cy, baseline)
    cam_R = np.stack([left.R_cam_from_ref, right.R_cam_from_ref])
    cam_t = np.stack([left.t_cam_from_ref, right.t_cam_from_ref])

    # Camera mounted looking along +x of the base (test_ba.cpp:134-139).
    R_bc = _roty(np.pi / 2) @ _rotz(-np.pi / 2)
    y_step = 0.2
    t_wb = np.stack(
        [
            np.full(num_poses, -4.0),
            -2.5 + y_step * np.arange(num_poses),
            np.zeros(num_poses),
        ],
        axis=-1,
    )
    R_wc = np.broadcast_to(R_bc, (num_poses, 3, 3))
    poses_true = np.zeros((num_poses, 4, 4))
    poses_true[:, :3, :3] = R_wc
    poses_true[:, :3, 3] = t_wb
    poses_true[:, 3, 3] = 1.0

    # Landmarks on a wall at x ~ 5, spread along the trajectory.
    anchor = rng.integers(0, max(num_poses - window, 1), num_points)
    pts = np.stack(
        [
            rng.uniform(4.0, 7.0, num_points),
            t_wb[anchor, 1] + rng.uniform(0.0, window * y_step, num_points),
            rng.uniform(-1.5, 1.5, num_points),
        ],
        axis=-1,
    )

    # Observations: point i seen from poses anchor..anchor+window-1, 2 cams.
    obs_point = np.repeat(np.arange(num_points, dtype=np.int32), window)
    obs_pose = (
        anchor.astype(np.int32)[:, None] + np.arange(window, dtype=np.int32)
    ).reshape(-1)
    obs_pose = np.minimum(obs_pose, num_poses - 1)
    obs_point = np.concatenate([obs_point, obs_point])
    obs_pose = np.concatenate([obs_pose, obs_pose])
    obs_camera = np.concatenate(
        [
            np.zeros(num_points * window, dtype=np.int32),
            np.ones(num_points * window, dtype=np.int32),
        ]
    )

    # Project through the true geometry in observation chunks (every op is
    # elementwise per observation row, so chunking changes no value).
    R_cw = np.transpose(poses_true[:, :3, :3], (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, poses_true[:, :3, 3])
    O = obs_pose.shape[0]
    obs_pixel = np.empty((O, 2), dtype=np.float64)
    chunk = _PROJECTION_CHUNK
    for s in range(0, O, chunk):
        e = min(s + chunk, O)
        jp, ip, cp = obs_pose[s:e], obs_point[s:e], obs_camera[s:e]
        local = np.einsum("oij,oj->oi", R_cw[jp], pts[ip]) + t_cw[jp]
        local = np.einsum("oij,oj->oi", cam_R[cp], local) + cam_t[cp]
        inv_z = 1.0 / local[:, 2]
        obs_pixel[s:e, 0] = fx * local[:, 0] * inv_z + cx
        obs_pixel[s:e, 1] = fy * local[:, 1] * inv_z + cy
    if pixel_noise > 0:
        obs_pixel = obs_pixel + rng.normal(0, pixel_noise, obs_pixel.shape)

    poses_initial = poses_true.copy()
    poses_initial[num_fixed_poses:, :3, 3] += rng.uniform(
        -pose_translation_error,
        pose_translation_error,
        (num_poses - num_fixed_poses, 3),
    )
    points_initial = pts + rng.uniform(-point_error, point_error, pts.shape)

    return StereoBAProblem(
        cameras=[left, right],
        poses_true=poses_true,
        poses_initial=poses_initial,
        points_true=pts,
        points_initial=points_initial,
        fixed_pose_ids=np.arange(num_fixed_poses),
        obs_camera=obs_camera,
        obs_pose=obs_pose,
        obs_point=obs_point,
        obs_pixel=obs_pixel,
    )
