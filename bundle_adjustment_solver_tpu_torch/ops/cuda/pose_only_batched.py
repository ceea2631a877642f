"""Batched pose-only Gauss-Newton statistics: wrappers, plain versions, and
the row-wise SE(3) math of the lockstep solvers.

Counterpart of the JAX package's `ops/pallas/pose_only_batched.py`. Four
kernels, written in CUDA C++ in `csrc/pose_only_batched.cu`, each compute
for B independent frames in one launch: the per-frame warp of P points,
pinhole projection, the Manhattan-Huber weight, and the frame's damped-GN
statistics reduced over its points:

  * `batched_mono_gn_stats` -- 6-DoF, one camera;
  * `batched_stereo_gn_stats` -- 6-DoF, left camera plus the right camera
    chained through the shared rig, summed;
  * `batched_planar_mono_gn_stats` -- planar 3-DoF (x, y, psi), the
    translation columns through the shared camera<-base rotation R_cb and
    the psi column through the lever of the base-frame point;
  * `batched_planar_stereo_gn_stats` -- planar, both cameras, the right one
    through R_rl R_cb.

The data contract is the stats and their order: for 6-DoF the (B, 28) rows
hold the 21 upper-triangle entries of J^T W J (row-major, a <= b), the 6
entries of J^T W r, then the robust cost sum w (r_u^2 + r_v^2); for planar
the (B, 10) rows hold 6 + 3 + 1. The TPU layout (frames along 128 lanes,
256-row point chunks, (32, B_pad) stat planes) is not part of it.

Layout here:
  * per-frame rows, frames along the row and no padding: `pose12` (12, B)
    = R row-major (9) and t (3) of the point warp; `intr8` (8, B) = [fx,
    fy, cx, cy] of the left camera then of the right (rows 4..7 unused for
    mono); `psi2` (2, B) = [cos psi, sin psi] (planar);
  * observation planes `obs` (k, B, P) float32, frame-major so one frame's
    points are contiguous: x, y, z, pu, pv, valid for the left camera, then
    pu, pv, valid for the right (k = 6 mono, 9 stereo). `valid` is 0 or 1.
    Planar planes hold base-frame points;
  * shared extrinsics as (3, 4) float32 tensors on the host (R | t): they
    go into the launch as kernel arguments, so the kernel reads no table
    for them and the solver's loop copies nothing to the card.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; any other device raises.
`<wrapper>.launches` counts kernel launches and `<plain>.calls` counts
calls of the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ..lie import (
    _one_minus_cos_over_theta_sq,
    _sin_theta_over_theta,
    _theta_minus_sin_over_theta_cubed,
)
from . import _build

STATS6 = 28  # 21 upper-tri J^T W J + 6 J^T W r + 1 cost
STATS3 = 10  # 6 upper-tri + 3 + 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ba_bgn_mono": [_P] * 4 + [_I, _I, _F, _P],
    "ba_bgn_stereo": [_P] * 5 + [_I, _I, _F, _P],
    "ba_bgn_planar_mono": [_P] * 6 + [_I, _I, _F, _P],
    "ba_bgn_planar_stereo": [_P] * 8 + [_I, _I, _F, _P],
}


def _lib():
    return _build.library("pose_only_batched", _SIGNATURES)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def obs_planes(points, pixels_left, valid_left, pixels_right=None,
               valid_right=None):
    """(B, P, 3) points, (B, P, 2) pixels and (B, P) float validity ->
    (6 | 9, B, P) contiguous float32 planes."""
    parts = [points.permute(2, 0, 1), pixels_left.permute(2, 0, 1),
             valid_left[None]]
    if pixels_right is not None:
        parts += [pixels_right.permute(2, 0, 1), valid_right[None]]
    return torch.cat(parts, dim=0).to(torch.float32).contiguous()


def intr_rows(rows, B, device):
    """Eight scalar or (B,) intrinsic values -> (8, B) float32 rows."""
    out = torch.zeros((len(rows), B), dtype=torch.float32, device=device)
    for k, r in enumerate(rows):
        out[k] = r
    return out


def pose_rows(R, t):
    """(B, 3, 3) + (B, 3) -> (12, B) pose rows."""
    B = R.shape[0]
    return torch.cat([R.reshape(B, 9), t], dim=1).T.contiguous()


def pose_rows_to_Rt(pose12):
    """(12, B) rows -> ((B, 3, 3), (B, 3))."""
    flat = pose12.T
    B = flat.shape[0]
    return flat[:, :9].reshape(B, 3, 3), flat[:, 9:12]


def mat34(R, t):
    """(3, 3) + (3,) -> contiguous (3, 4) float32 on the host, the form in
    which a shared extrinsic goes into a launch."""
    return torch.cat([R, t[:, None]], dim=1).to(
        device="cpu", dtype=torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Row-wise SE(3) math for the lockstep solvers (the pose carry is (12, B)
# rows, so an update is elementwise work on (B,) rows)
# ---------------------------------------------------------------------------


def se3_exp_rows(xi_rows):
    """(6, B) twist rows [v; w] -> (9 R rows, 3 t rows), lists of (B,).

    Same guarded coefficients as ops/lie.se3_exp; wx^2 is expanded
    algebraically as w w^T - theta^2 I (identical up to rounding).
    """
    v0, v1, v2 = xi_rows[0], xi_rows[1], xi_rows[2]
    w0, w1, w2 = xi_rows[3], xi_rows[4], xi_rows[5]
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    a = _sin_theta_over_theta(th2)
    b = _one_minus_cos_over_theta_sq(th2)
    c = _theta_minus_sin_over_theta_cubed(th2)

    def rot(coef_skew, coef_sq):
        # I + cs * wx + cq * (w w^T - th2 I), row-major 9 rows.
        return [
            1.0 + coef_sq * (w0 * w0 - th2),
            -coef_skew * w2 + coef_sq * w0 * w1,
            coef_skew * w1 + coef_sq * w0 * w2,
            coef_skew * w2 + coef_sq * w0 * w1,
            1.0 + coef_sq * (w1 * w1 - th2),
            -coef_skew * w0 + coef_sq * w1 * w2,
            -coef_skew * w1 + coef_sq * w0 * w2,
            coef_skew * w0 + coef_sq * w1 * w2,
            1.0 + coef_sq * (w2 * w2 - th2),
        ]

    R = rot(a, b)
    V = rot(b, c)
    t = [
        V[0] * v0 + V[1] * v1 + V[2] * v2,
        V[3] * v0 + V[4] * v1 + V[5] * v2,
        V[6] * v0 + V[7] * v1 + V[8] * v2,
    ]
    return R, t


def compose_rows(Ar, At, Br, Bt):
    """Row-wise rigid compose (A R, A t) * (B R, B t) on lists of (B,) rows
    or scalars. Returns (9 rows, 3 rows) of A @ B."""
    Cr = []
    for i in range(3):
        for j in range(3):
            Cr.append(
                Ar[3 * i] * Br[j]
                + Ar[3 * i + 1] * Br[3 + j]
                + Ar[3 * i + 2] * Br[6 + j]
            )
    Ct = [
        Ar[3 * i] * Bt[0] + Ar[3 * i + 1] * Bt[1] + Ar[3 * i + 2] * Bt[2]
        + At[i]
        for i in range(3)
    ]
    return Cr, Ct


def add_front_se3_rows(pose12, delta_rows):
    """exp(delta) * pose on (12, B) pose rows; delta_rows (6, B)."""
    dR, dt = se3_exp_rows(delta_rows)
    R = [pose12[k] for k in range(9)]
    t = [pose12[9 + k] for k in range(3)]
    Cr, Ct = compose_rows(dR, dt, R, t)
    return torch.stack(Cr + Ct)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' math on (B, P) planes, reduced over points
# ---------------------------------------------------------------------------


def _warp(pose12, x, y, z):
    """Per-frame warp of (B, P) point planes by (12, B) pose rows."""
    r = lambda k: pose12[k][:, None]
    xc = r(0) * x + r(1) * y + r(2) * z + r(9)
    yc = r(3) * x + r(4) * y + r(5) * z + r(10)
    zc = r(6) * x + r(7) * y + r(8) * z + r(11)
    return xc, yc, zc


def _rig_warp(m, x, y, z):
    """Warp by a shared (3, 4) extrinsic given as nested Python floats."""
    return tuple(m[i][0] * x + m[i][1] * y + m[i][2] * z + m[i][3]
                 for i in range(3))


def _weighted(zc, xc, yc, pu, pv, fx, fy, cx, cy, valid, huber, divide):
    """Guarded depth, residuals and Manhattan-Huber weight. `divide` picks
    the 6-DoF form (x/z first) or the planar form (fx x / z)."""
    zc = torch.where(valid > 0, zc, torch.ones_like(zc))
    inv_z = 1.0 / zc
    if divide:
        xiz, yiz = xc * inv_z, yc * inv_z
        ru = fx * xiz + cx - pu
        rv = fy * yiz + cy - pv
    else:
        xiz = yiz = None
        ru = fx * xc * inv_z + cx - pu
        rv = fy * yc * inv_z + cy - pv
    man = ru.abs() + rv.abs()
    w = torch.where(man > huber, huber / man, torch.ones_like(man)) * valid
    return inv_z, xiz, yiz, ru, rv, w


def _reduce(ju, jv, w, ru, rv):
    """Upper-tri J^T W J, J^T W r and the cost, each summed over points."""
    n = len(ju)
    stats = [(w * (ju[a] * ju[b] + jv[a] * jv[b])).sum(-1)
             for a in range(n) for b in range(a, n)]
    wru, wrv = w * ru, w * rv
    stats += [(wru * ju[a] + wrv * jv[a]).sum(-1) for a in range(n)]
    stats.append((w * (ru * ru + rv * rv)).sum(-1))
    return stats


def _cam_stats(xc, yc, zc, pu, pv, fx, fy, cx, cy, valid, huber):
    """28 (B,) stat columns of one camera, 6-DoF (Jacobian w.r.t. this
    camera's frame; pose_only_batched._cam_stats_lanes)."""
    inv_z, xiz, yiz, ru, rv, w = _weighted(
        zc, xc, yc, pu, pv, fx, fy, cx, cy, valid, huber, divide=True)
    fxiz = fx * inv_z
    fyiz = fy * inv_z
    zero = torch.zeros_like(fxiz)
    ju = (fxiz, zero, -fxiz * xiz, -fx * xiz * yiz, fx * (1.0 + xiz * xiz),
          -fx * yiz)
    jv = (zero, fyiz, -fyiz * yiz, -fy * (1.0 + yiz * yiz), fy * xiz * yiz,
          fy * xiz)
    return _reduce(ju, jv, w, ru, rv)


def _cam_stats_planar(xc, yc, zc, pu, pv, fx, fy, cx, cy, cpsi, spsi, xb, yb,
                      rcb, valid, huber):
    """10 (B,) stat columns of one camera, planar 3-DoF
    (pose_only_batched._cam_stats_planar_lanes); `rcb` nested floats."""
    inv_z, _, _, ru, rv, w = _weighted(
        zc, xc, yc, pu, pv, fx, fy, cx, cy, valid, huber, divide=False)
    fx_inv_z = fx * inv_z
    fy_inv_z = fy * inv_z
    du_dz = -fx_inv_z * xc * inv_z
    dv_dz = -fy_inv_z * yc * inv_z
    ju_x = fx_inv_z * rcb[0][0] + du_dz * rcb[2][0]
    ju_y = fx_inv_z * rcb[0][1] + du_dz * rcb[2][1]
    jv_x = fy_inv_z * rcb[1][0] + dv_dz * rcb[2][0]
    jv_y = fy_inv_z * rcb[1][1] + dv_dz * rcb[2][1]
    A = -spsi * xb - cpsi * yb
    B = cpsi * xb - spsi * yb
    ju = (ju_x, ju_y, ju_x * A + ju_y * B)
    jv = (jv_x, jv_y, jv_x * A + jv_y * B)
    return _reduce(ju, jv, w, ru, rv)


def _icol(intr8, k):
    return intr8[k][:, None]


def batched_mono_gn_stats_plain(pose12, intr8, obs, huber):
    """Plain version of the mono kernel: (B, 28)."""
    batched_mono_gn_stats_plain.calls += 1
    x, y, z, pu, pv, v = obs
    xc, yc, zc = _warp(pose12, x, y, z)
    i = lambda k: _icol(intr8, k)
    return torch.stack(_cam_stats(xc, yc, zc, pu, pv, i(0), i(1), i(2), i(3),
                                  v, huber), dim=1)


def batched_stereo_gn_stats_plain(pose12, intr8, rig34, obs, huber):
    """Plain version of the stereo kernel: (B, 28), left + right."""
    batched_stereo_gn_stats_plain.calls += 1
    x, y, z, pul, pvl, vl, pur, pvr, vr = obs
    xl, yl, zl = _warp(pose12, x, y, z)
    i = lambda k: _icol(intr8, k)
    sl = _cam_stats(xl, yl, zl, pul, pvl, i(0), i(1), i(2), i(3), vl, huber)
    xr, yr, zr = _rig_warp(rig34.tolist(), xl, yl, zl)
    sr = _cam_stats(xr, yr, zr, pur, pvr, i(4), i(5), i(6), i(7), vr, huber)
    return torch.stack([a + b for a, b in zip(sl, sr)], dim=1)


def batched_planar_mono_gn_stats_plain(pose12, intr8, psi2, rcb34, obs,
                                       huber):
    """Plain version of the planar mono kernel: (B, 10)."""
    batched_planar_mono_gn_stats_plain.calls += 1
    x, y, z, pu, pv, v = obs
    xc, yc, zc = _warp(pose12, x, y, z)
    i = lambda k: _icol(intr8, k)
    return torch.stack(_cam_stats_planar(
        xc, yc, zc, pu, pv, i(0), i(1), i(2), i(3), psi2[0][:, None],
        psi2[1][:, None], x, y, rcb34.tolist(), v, huber), dim=1)


def batched_planar_stereo_gn_stats_plain(pose12, intr8, psi2, rcb34, rcbr34,
                                         rig34, obs, huber):
    """Plain version of the planar stereo kernel: (B, 10), left + right."""
    batched_planar_stereo_gn_stats_plain.calls += 1
    x, y, z, pul, pvl, vl, pur, pvr, vr = obs
    xl, yl, zl = _warp(pose12, x, y, z)
    i = lambda k: _icol(intr8, k)
    cp, sp = psi2[0][:, None], psi2[1][:, None]
    sl = _cam_stats_planar(xl, yl, zl, pul, pvl, i(0), i(1), i(2), i(3), cp,
                           sp, x, y, rcb34.tolist(), vl, huber)
    xr, yr, zr = _rig_warp(rig34.tolist(), xl, yl, zl)
    sr = _cam_stats_planar(xr, yr, zr, pur, pvr, i(4), i(5), i(6), i(7), cp,
                           sp, x, y, rcbr34.tolist(), vr, huber)
    return torch.stack([a + b for a, b in zip(sl, sr)], dim=1)


for _fn in (batched_mono_gn_stats_plain, batched_stereo_gn_stats_plain,
            batched_planar_mono_gn_stats_plain,
            batched_planar_stereo_gn_stats_plain):
    _fn.calls = 0


def gn_stats_rounding_scale(stats):
    """(B, 28) or (B, 10) stats -> the float64 scale that each entry's
    float32 rounding is relative to: a bound on the sum of the magnitudes
    of its terms (Cauchy-Schwarz, with w >= 0), sqrt(A_aa A_bb) for
    J^T W J (a, b), sqrt(A_aa cost) for J^T W r (a), and the cost itself.
    Two evaluations of the same stats in another order differ by a small
    multiple of float32's epsilon times this, also where an entry cancels
    to zero (with fx = fy, J^T W J (2, 5) of the 6-DoF stats is zero in
    exact arithmetic)."""
    stats = stats.double()
    d = 6 if stats.shape[1] == STATS6 else 3
    pairs = [(a, b) for a in range(d) for b in range(a, d)]
    diag = stats[:, [pairs.index((a, a)) for a in range(d)]].clamp_min(0)
    cost = stats[:, -1:].clamp_min(0)
    rows, cols = zip(*pairs)
    return torch.cat([(diag[:, list(rows)] * diag[:, list(cols)]).sqrt(),
                      (diag * cost).sqrt(), cost], dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(pose12, intr8, obs, k, psi2=None, mats=()):
    """Validate what a kernel reads through raw pointers; returns (B, P).
    Raises on a device other than the CPU or CUDA."""
    dev = obs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if obs.dim() != 3 or obs.shape[0] != k:
        raise ValueError(f"obs must be ({k}, B, P), got {tuple(obs.shape)}")
    B, P = obs.shape[1], obs.shape[2]
    rows = [("pose12", pose12, (12, B)), ("intr8", intr8, (8, B)),
            ("obs", obs, (k, B, P))]
    if psi2 is not None:
        rows.append(("psi2", psi2, (2, B)))
    for name, t, shape in rows:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}")
    for name, m in mats:
        if (m.device.type != "cpu" or m.dtype != torch.float32
                or tuple(m.shape) != (3, 4) or not m.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (3, 4) float32 "
                             f"tensor on the host")
    return B, P


def _launch(fn_name, args, B, P, huber, dev, nstats):
    out = torch.empty((B, nstats), dtype=torch.float32, device=dev)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args + (out,)]
    err = getattr(_lib(), fn_name)(
        *ptrs, B, P, float(huber),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, fn_name)
    return out


def batched_mono_gn_stats(pose12, intr8, obs, huber):
    """(B, 28) mono 6-DoF stats. pose12 (12, B), intr8 (8, B) (rows 4..7
    unused), obs (6, B, P); huber in pixels."""
    B, P = _check(pose12, intr8, obs, 6)
    if obs.device.type == "cpu":
        return batched_mono_gn_stats_plain(pose12, intr8, obs, huber)
    out = _launch("ba_bgn_mono", (pose12, intr8, obs), B, P, huber,
                  obs.device, STATS6)
    batched_mono_gn_stats.launches += 1
    return out


def batched_stereo_gn_stats(pose12, intr8, rig34, obs, huber):
    """(B, 28) summed left + right stereo 6-DoF stats. rig34: (3, 4)
    right<-left extrinsic on the host, shared by every frame; obs
    (9, B, P)."""
    B, P = _check(pose12, intr8, obs, 9, mats=[("rig34", rig34)])
    if obs.device.type == "cpu":
        return batched_stereo_gn_stats_plain(pose12, intr8, rig34, obs, huber)
    out = _launch("ba_bgn_stereo", (pose12, intr8, rig34, obs), B, P, huber,
                  obs.device, STATS6)
    batched_stereo_gn_stats.launches += 1
    return out


def batched_planar_mono_gn_stats(pose12, intr8, psi2, rcb34, obs, huber):
    """(B, 10) planar mono stats. pose12: camera<-base1 rows; psi2 (2, B)
    cos/sin psi; rcb34: (3, 4) camera<-base extrinsic on the host; obs
    (6, B, P) with base-frame points."""
    B, P = _check(pose12, intr8, obs, 6, psi2, [("rcb34", rcb34)])
    if obs.device.type == "cpu":
        return batched_planar_mono_gn_stats_plain(
            pose12, intr8, psi2, rcb34, obs, huber)
    out = _launch("ba_bgn_planar_mono", (pose12, intr8, psi2, rcb34, obs),
                  B, P, huber, obs.device, STATS3)
    batched_planar_mono_gn_stats.launches += 1
    return out


def batched_planar_stereo_gn_stats(pose12, intr8, psi2, rcb34, rcbr34, rig34,
                                   obs, huber):
    """(B, 10) summed left + right planar stats. rcbr34: (3, 4) with
    R_rl R_cb and a zero translation column; rig34: right<-left; all three
    on the host. obs (9, B, P)."""
    B, P = _check(pose12, intr8, obs, 9, psi2,
                  [("rcb34", rcb34), ("rcbr34", rcbr34), ("rig34", rig34)])
    if obs.device.type == "cpu":
        return batched_planar_stereo_gn_stats_plain(
            pose12, intr8, psi2, rcb34, rcbr34, rig34, obs, huber)
    out = _launch("ba_bgn_planar_stereo",
                  (pose12, intr8, psi2, rcb34, rcbr34, rig34, obs), B, P,
                  huber, obs.device, STATS3)
    batched_planar_stereo_gn_stats.launches += 1
    return out


for _fn in (batched_mono_gn_stats, batched_stereo_gn_stats,
            batched_planar_mono_gn_stats, batched_planar_stereo_gn_stats):
    _fn.launches = 0
