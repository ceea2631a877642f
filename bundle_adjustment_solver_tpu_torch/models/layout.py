"""Point-major padded observation layout for full BA.

Counterpart of the JAX package's `models/layout.py` (`PointMajorProblem`,
`PMShape`, and the vectorized-numpy path of `build_point_major`):

  * observations are grouped by landmark ("point-major") and padded to a
    static number of pose-slots `Kp` per landmark, each slot carrying the
    problem's `C` rig cameras -- so every point-side reduction (the C/b/U
    blocks of the Schur system) is a sum over a static axis;
  * every per-observation plane keeps the LANDMARK axis last, so a kernel
    thread that owns one landmark reads each plane row coalesced with its
    neighbours;
  * landmarks are sorted by their minimum observing pose, so each block of
    `bm` landmarks touches only a narrow window `P` of poses -- the kernels
    stage that window of the pose table in shared memory and gather and
    scatter through it by index (ops/cuda/full_ba_pm.py).

Fixed (gauge) parameters dissolve into the layout: a fixed pose keeps its
real index in `slot_pose` (it must still be warped through) but carries
`slot_opt = -1`, which no scatter matches, so its Hessian contribution is
dropped exactly like the reference's sentinel remap
(core/full_bundle_adjustment_solver.cpp:182-206). A fixed landmark gets
`point_mask = 0`, which zeroes C -> the closed-form inverse guard returns
Cinv = 0 -> its Schur correction, back-substituted step, and rhs
contribution all vanish while its residuals still weight the pose system.

The native fill of the JAX package (csrc/problem_compiler.cpp), its device
build and `PMLayoutCache` are not ported yet; this builder gives the same
planes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PointMajorProblem", "PMShape", "build_point_major"]


class PointMajorProblem(NamedTuple):
    """Static-shape point-major tensors.

    Plane layout conventions (landmark axis last, length Mp):
      obs_f32 (3*Kp*C, Mp): rows [0, KpC) = pixel u, [KpC, 2KpC) = pixel v,
        [2KpC, 3KpC) = validity (1.0/0.0); within a plane, row c*Kp + k is
        pose-slot k of camera c (cam-major). Pixels are scale-conditioned.
      slot_pose (Kp, Mp) int32: real pose index warped through (0 on padding).
      slot_opt (Kp, Mp) int32: optimization index of that pose, or -1 when the
        pose is fixed / the slot is padding.
      X (4, Mp): rows x, y, z (scale-conditioned), point_mask (1.0 for an
        optimizable landmark, 0.0 for fixed/padding).
      point_ref (Mp,) int32: original landmark row for write-back (-1 pad).
      gbase/sbase (nblocks,) int32: per-block pose-window bases of the
        gather (real pose index) and the scatter (opt index), aligned down
        to multiples of 8.
    """

    obs_f32: torch.Tensor
    slot_pose: torch.Tensor
    slot_opt: torch.Tensor
    X: torch.Tensor
    point_ref: torch.Tensor
    gbase: torch.Tensor
    sbase: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PMShape:
    """Hashable static dimensions of a point-major problem."""

    num_poses: int  # N
    num_opt_poses: int  # N_opt
    num_points: int  # M (real landmarks)
    padded_points: int  # Mp (multiple of block_points)
    num_observations: int  # real observation count
    slots: int  # Kp: padded pose-slots per landmark
    cams: int  # C: rig cameras
    block_points: int  # bm: landmarks per kernel block
    window: int  # P: pose window per block
    scale: float
    # When the optimizable poses are one contiguous, identity-ordered row
    # range [opt_start, opt_start + num_opt_poses) of the pose array (the
    # common SLAM case: fix the first/last K frames), the solver replaces
    # the per-iteration gather/scatter of pose rows with slices. None = the
    # general gather/scatter path.
    opt_start: int | None = None

    @property
    def num_blocks(self) -> int:
        return self.padded_points // self.block_points


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_point_major(
    obs_pose: np.ndarray,  # (O,) int32 pose index per observation
    obs_point: np.ndarray,  # (O,) int32 landmark index
    obs_cam: np.ndarray,  # (O,) int32 rig camera index
    obs_pixel: np.ndarray,  # (O, 2) scale-conditioned pixels
    points: np.ndarray,  # (M, 3) scale-conditioned landmark positions
    pose_opt_of: np.ndarray,  # (N,) int32: opt index or num_opt_poses (fixed)
    point_is_opt: np.ndarray,  # (M,) bool
    num_cameras: int,
    scale: float,
    num_opt_poses: int,
    block_points: int = 256,
    max_slots: int = 32,
    max_window: int = 2048,
    pad_blocks_to: int = 1,  # make num_blocks divisible by this
    device: torch.device | str | None = None,
) -> tuple[PointMajorProblem, PMShape] | None:
    """Build the point-major layout on the host and place it on `device`,
    or return None when the problem does not fit its static bounds (a
    landmark observed from > max_slots poses, a landmark block whose pose
    span exceeds max_window, or a duplicate (landmark, pose, camera)
    observation, which the one-cell-per-slot-camera planes cannot hold).
    """
    device = resolve_device(device)
    dtype = np.float32
    # Landmark blocks stay multiples of 128 wide, as in the JAX package, so
    # both packages build the same planes for the same arguments.
    block_points = max(128, _round_up(int(block_points), 128))

    O = int(obs_pose.shape[0])
    M = int(points.shape[0])
    N = int(pose_opt_of.shape[0])
    if O == 0:
        return None
    n_opt = int(num_opt_poses)
    C = int(num_cameras)

    triple = (
        obs_point.astype(np.int64) * (N * C)
        + obs_pose.astype(np.int64) * C
        + obs_cam.astype(np.int64)
    )
    if np.unique(triple).size != O:
        return None
    # Group observations by (landmark, pose); each (i, j) pair becomes one
    # slot with C camera entries.
    order = np.lexsort((obs_cam, obs_pose, obs_point))
    op = obs_point[order]
    oj = obs_pose[order]
    oc = obs_cam[order]
    opix = obs_pixel[order]

    # Unique (point, pose) pairs, their slot index within the point.
    pair_key = op.astype(np.int64) * N + oj
    pair_change = np.empty(O, dtype=bool)
    pair_change[0] = True
    np.not_equal(pair_key[1:], pair_key[:-1], out=pair_change[1:])
    pair_id = np.cumsum(pair_change) - 1  # (O,) dense pair index
    num_pairs = int(pair_id[-1]) + 1
    pair_point = op[pair_change]
    pair_pose = oj[pair_change]

    point_change = np.empty(num_pairs, dtype=bool)
    point_change[0] = True
    np.not_equal(pair_point[1:], pair_point[:-1], out=point_change[1:])
    point_first_pair = np.nonzero(point_change)[0]
    slot_of_pair = np.arange(num_pairs) - np.repeat(
        point_first_pair, np.diff(np.append(point_first_pair, num_pairs))
    )
    kp = int(slot_of_pair.max()) + 1
    if kp > max_slots:
        return None
    Kp = max(1, _round_up(kp, 4))

    # Sort landmarks by minimum observing pose for window locality;
    # landmarks with no observations keep their position at the end.
    min_pose = np.full(M, N, dtype=np.int64)
    np.minimum.at(min_pose, pair_point, pair_pose)
    pt_order = np.argsort(min_pose, kind="stable").astype(np.int32)
    rank_of_point = np.empty(M, dtype=np.int32)
    rank_of_point[pt_order] = np.arange(M, dtype=np.int32)

    bm = int(block_points)
    Mp = _round_up(max(M, bm), bm * max(1, int(pad_blocks_to)))
    nblocks = Mp // bm

    # Scatter observations into the padded planes.
    row_pt = rank_of_point[op]  # (O,) padded landmark row
    slot = slot_of_pair[pair_id]  # (O,) pose-slot within the landmark
    plane_row = oc * Kp + slot  # cam-major: each camera's slots adjoin

    obs_f32 = np.zeros((3 * Kp * C, Mp), dtype=dtype)
    kc = Kp * C
    obs_f32[plane_row, row_pt] = opix[:, 0].astype(dtype)
    obs_f32[kc + plane_row, row_pt] = opix[:, 1].astype(dtype)
    obs_f32[2 * kc + plane_row, row_pt] = 1.0
    valid_plane = obs_f32[2 * kc:]

    slot_pose = np.zeros((Kp, Mp), dtype=np.int32)
    slot_opt = np.full((Kp, Mp), -1, dtype=np.int32)
    pair_row_pt = rank_of_point[pair_point]
    slot_pose[slot_of_pair, pair_row_pt] = pair_pose.astype(np.int32)
    so = pose_opt_of[pair_pose].astype(np.int32)
    so[so == n_opt] = -1  # fixed-pose sentinel -> never scattered
    slot_opt[slot_of_pair, pair_row_pt] = so

    X = np.zeros((4, Mp), dtype=dtype)
    X[0, rank_of_point] = points[:, 0].astype(dtype)
    X[1, rank_of_point] = points[:, 1].astype(dtype)
    X[2, rank_of_point] = points[:, 2].astype(dtype)
    X[3, rank_of_point] = point_is_opt.astype(dtype)

    point_ref = np.full(Mp, -1, dtype=np.int32)
    point_ref[rank_of_point] = np.arange(M, dtype=np.int32)

    # Per-block pose windows. Padding slots carry pose 0 / opt -1, so only
    # real slots (valid somewhere) constrain the gather window; a padding
    # slot's pose 0 may fall outside the window, where the kernels read a
    # zero pose row (its observations are invalid, so it adds nothing).
    imax = np.iinfo(np.int32).max
    sp_blocks = slot_pose.reshape(Kp, nblocks, bm)
    has_obs = (
        valid_plane.reshape(C, Kp, Mp).max(axis=0).reshape(Kp, nblocks, bm)
        > 0
    )
    gmin = np.where(has_obs, sp_blocks, imax).min(axis=(0, 2))
    gmax = np.where(has_obs, sp_blocks, -1).max(axis=(0, 2))
    so_blocks = slot_opt.reshape(Kp, nblocks, bm)
    smin = np.where(so_blocks >= 0, so_blocks, imax).min(axis=(0, 2))
    smax = so_blocks.max(axis=(0, 2))

    empty = gmax < 0
    gmin[empty] = 0
    gmax[empty] = 0
    gbase = (gmin // 8) * 8
    gspan = int((gmax - gbase).max()) + 1

    sempty = smax < 0
    smin[sempty] = 0
    smax[sempty] = 0
    sbase = (np.minimum(smin, imax - 8) // 8) * 8
    sbase[sempty] = 0
    sspan = int((smax - sbase).max()) + 1

    # P is the widest block's span rounded up to a multiple of 8 (the
    # second-level sum groups panel rows in 8-row tiles). The JAX package
    # additionally rounds P above 256 to a multiple of 256, a tiling rule of
    # its TPU kernels; this port does not, so the two layouts differ only
    # in P, and only for windows wider than 256.
    P = max(8, _round_up(max(gspan, sspan, 8), 8))
    if P > max_window:
        return None
    # In-bounds invariant: gbase <= N-1 and sbase <= n_opt-1, and the
    # kernels' pose tables are padded by +P rows (to N+P / n_opt+P), so
    # every window [base, base + P) lies inside its table.

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pm = PointMajorProblem(
        obs_f32=dev(obs_f32),
        slot_pose=dev(slot_pose),
        slot_opt=dev(slot_opt),
        X=dev(X),
        point_ref=dev(point_ref),
        gbase=dev(gbase.astype(np.int32)),
        sbase=dev(sbase.astype(np.int32)),
    )
    # Contiguity probe for the fast pose gather/scatter (see PMShape).
    opt_start = None
    if n_opt > 0:
        opt_rows = np.nonzero(pose_opt_of < n_opt)[0]
        if opt_rows.size == n_opt:
            s0 = int(opt_rows[0])
            if int(opt_rows[-1]) == s0 + n_opt - 1 and np.array_equal(
                pose_opt_of[s0 : s0 + n_opt],
                np.arange(n_opt, dtype=pose_opt_of.dtype),
            ):
                opt_start = s0

    shape = PMShape(
        num_poses=N,
        num_opt_poses=n_opt,
        num_points=M,
        padded_points=Mp,
        num_observations=O,
        slots=Kp,
        cams=C,
        block_points=bm,
        window=P,
        scale=scale,
        opt_start=opt_start,
    )
    return pm, shape
