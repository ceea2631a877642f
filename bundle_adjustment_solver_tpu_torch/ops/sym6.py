"""Flat symmetric-6x6 block algebra for the pose system.

Counterpart of the JAX package's `ops/sym6.py`. The reduced camera system
works with N_opt symmetric 6x6 pose blocks, kept FLAT as (N, 21)
upper-triangle component columns (row-major (a, b) with a <= b -- the order
of the assembly kernel's panel columns, ops/cuda/full_ba_pm.py). Three
operations act directly on the columns: matvec, diagonal damping, and a
closed-form inverse via 2x2-of-3x3 blockwise Schur.
"""

from __future__ import annotations

import torch

_TRI6 = [(a, b) for a in range(6) for b in range(a, 6)]
_IDX = {ab: n for n, ab in enumerate(_TRI6)}
DIAG_IDX = [_IDX[(a, a)] for a in range(6)]


def _at(Atri, a, b):
    """Component column (N,) of entry (a, b) of the symmetric block."""
    key = (a, b) if a <= b else (b, a)
    return Atri[:, _IDX[key]]


def tri6_matvec(Atri: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x per block. Atri (N, 21), x (N, 6) -> (N, 6)."""
    cols = []
    for a in range(6):
        acc = _at(Atri, a, 0) * x[:, 0]
        for b in range(1, 6):
            acc = acc + _at(Atri, a, b) * x[:, b]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def tri6_damp(Atri: torch.Tensor, lam) -> torch.Tensor:
    """(1 + lambda) diagonal damping without leaving the flat layout.
    `lam` is a float or a 0-dim tensor on Atri's device; the scale row is
    filled in place, so no host-to-device copy stalls the stream."""
    scale = torch.ones((21,), dtype=Atri.dtype, device=Atri.device)
    damp = 1.0 + lam
    for i in DIAG_IDX:
        scale[i] = damp
    return Atri * scale[None, :]


def _inv_sym3_cols(c):
    """Closed-form inverse of symmetric 3x3 from 6 columns
    [xx, xy, xz, yy, yz, zz]; zero when singular (cf. the kernel-side
    inverse in csrc/full_ba_pm.cu)."""
    a, b, c_, d, e, f = c
    co00 = d * f - e * e
    co01 = c_ * e - b * f
    co02 = b * e - c_ * d
    det = a * co00 + b * co01 + c_ * co02
    ok = det > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    inv_det = torch.where(ok, 1.0 / safe, torch.zeros_like(det))
    return [
        co00 * inv_det,
        co01 * inv_det,
        co02 * inv_det,
        (a * f - c_ * c_) * inv_det,
        (b * c_ - a * e) * inv_det,
        (a * d - b * b) * inv_det,
    ]


def inverse_tri6(Atri: torch.Tensor) -> torch.Tensor:
    """Blockwise-Schur inverse of each symmetric 6x6, flat in / flat out.

    A = [[P, Q], [Q^T, S]] with P, S symmetric 3x3 and Q full 3x3:
      Pinv, W = Pinv Q, M = S - Q^T W, Minv,
      TL = Pinv + W Minv W^T, TR = -W Minv, BR = Minv.
    Damped Gauss-Newton blocks are SPD, so P and M are invertible; the
    singular guard returns zeros (frozen block).
    """
    A = lambda a, b: _at(Atri, a, b)
    p = [A(0, 0), A(0, 1), A(0, 2), A(1, 1), A(1, 2), A(2, 2)]
    q = [[A(i, 3 + j) for j in range(3)] for i in range(3)]  # q[i][j]
    s = [A(3, 3), A(3, 4), A(3, 5), A(4, 4), A(4, 5), A(5, 5)]

    pi = _inv_sym3_cols(p)
    psym = [[pi[0], pi[1], pi[2]], [pi[1], pi[3], pi[4]], [pi[2], pi[4], pi[5]]]
    # W = Pinv @ Q (full 3x3).
    W = [
        [sum(psym[i][k] * q[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    # M = S - Q^T W (symmetric; compute upper triangle).
    ssym = [[s[0], s[1], s[2]], [s[1], s[3], s[4]], [s[2], s[4], s[5]]]
    m = [
        ssym[i][j] - sum(q[k][i] * W[k][j] for k in range(3))
        for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    ]
    mi = _inv_sym3_cols(m)
    msym = [[mi[0], mi[1], mi[2]], [mi[1], mi[3], mi[4]], [mi[2], mi[4], mi[5]]]
    # TR = -W @ Minv (full), TL = Pinv - TR @ W^T (symmetric), BR = Minv.
    TR = [
        [-sum(W[i][k] * msym[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    TL = [
        [
            psym[i][j] - sum(TR[i][k] * W[j][k] for k in range(3))
            for j in range(3)
        ]
        for i in range(3)
    ]

    cols = [None] * 21
    for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]:
        cols[_IDX[(i, j)]] = TL[i][j]
        cols[_IDX[(3 + i, 3 + j)]] = msym[i][j]
    for i in range(3):
        for j in range(3):
            cols[_IDX[(i, 3 + j)]] = TR[i][j]
    return torch.stack(cols, dim=1)
