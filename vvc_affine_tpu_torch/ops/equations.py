"""Normal-equation assembly for gradient-based CPMV refinement.

Port of the JAX package's ``ops/equations.py``.  Behavioural spec:
affine.cl:671-717 — for every sample of a CU, coefficients iC are built from
the Sobel gradients and the sample's sub-block centre (cx, cy), and the
(2nCP)x(2nCP) system M = sum iC iC^T, rhs = sum (iC*err)<<3 is accumulated
in int64.

Every iC is a linear form iC_p = a_p(cx,cy) * gx + b_p(cx,cy) * gy with
(a_p, b_p) constant per sub-block, so
    sum_samples iC_p iC_q = sum_subblocks [ a_p a_q * m20 + (a_p b_q + a_q b_p)
                            * m11 + b_p b_q * m02 ]
where m20/m11/m02 are the per-sub-block gradient moments sum(gx*gx),
sum(gx*gy), sum(gy*gy), and likewise rhs uses sum(gx*err), sum(gy*err).
All products and sums are int64 (integer sums are exact in any order), and
no integer matmul is used (the card has none for int64).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SubblockFactors(NamedTuple):
    """Static per-sub-block linear-form factors for one CU shape (int64
    numpy arrays from ``subblock_factors``, or tensors on a device)."""

    aa: np.ndarray  # int64 [S, P, P]  a_p*a_q
    ab: np.ndarray  # int64 [S, P, P]  a_p*b_q + a_q*b_p
    bb: np.ndarray  # int64 [S, P, P]  b_p*b_q
    a: np.ndarray   # int64 [S, P]
    b: np.ndarray   # int64 [S, P]


def subblock_factors(sb_rows: int, sb_cols: int, n_cp: int) -> SubblockFactors:
    """Factors for a CU with sb_rows x sb_cols sub-blocks (raster order).

    cx/cy are the sub-block centres in CU-local sample coordinates
    (affine.cl:680-681): cx = 4*col + 2, cy = 4*row + 2.
    """
    s = np.arange(sb_rows * sb_cols, dtype=np.int64)
    cx = (s % sb_cols) * 4 + 2
    cy = (s // sb_cols) * 4 + 2
    one = np.ones_like(s)
    zero = np.zeros_like(s)
    if n_cp == 3:
        # iC = [gx, cx*gx, gy, cx*gy, cy*gx, cy*gy] (affine.cl:684-689)
        a = np.stack([one, cx, zero, zero, cy, zero], axis=1)
        b = np.stack([zero, zero, one, cx, zero, cy], axis=1)
    else:
        # iC = [gx, cx*gx + cy*gy, gy, cy*gx - cx*gy] (affine.cl:691-694)
        a = np.stack([one, cx, zero, cy], axis=1)
        b = np.stack([zero, cy, one, -cx], axis=1)
    aa = a[:, :, None] * a[:, None, :]
    bb = b[:, :, None] * b[:, None, :]
    ab = a[:, :, None] * b[:, None, :] + b[:, :, None] * a[:, None, :]
    return SubblockFactors(aa, ab, bb, a, b)


def factors_to(fac: SubblockFactors, device) -> SubblockFactors:
    """The factors as int64 tensors on ``device``."""
    return SubblockFactors(*(torch.as_tensor(np.asarray(f, np.int64),
                                             device=device) for f in fac))


def gradient_moments(gx, gy, err):
    """Per-sub-block int64 moments.

    gx/gy/err: int32 [..., h, w] -> five tensors int64 [..., h//4 * w//4].
    """
    h, w = gx.shape[-2], gx.shape[-1]
    sh, sw = h // 4, w // 4

    def blocks(x):
        # widen BEFORE the products, as the JAX function does, so the
        # moments are exact for any int32 gradient and error
        return x.to(torch.int64).reshape(x.shape[:-2] + (sh, 4, sw, 4))

    gxb, gyb, eb = blocks(gx), blocks(gy), blocks(err)

    def moment(u, v):
        m = (u * v).sum(dim=(-3, -1))  # [..., sh, sw]
        return m.reshape(m.shape[:-2] + (sh * sw,))

    return (
        moment(gxb, gxb),
        moment(gxb, gyb),
        moment(gyb, gyb),
        moment(gxb, eb),
        moment(gyb, eb),
    )


def assemble_system(m20, m11, m02, me1, me2, fac: SubblockFactors):
    """Moments int64 [..., S] + factor tensors -> (M int64 [..., P, P],
    rhs int64 [..., P]).

    The rhs carries the reference's <<3 scaling (affine.cl:704), on int64.
    """
    M = (m20[..., None, None] * fac.aa + m11[..., None, None] * fac.ab
         + m02[..., None, None] * fac.bb).sum(dim=-3)
    rhs = (me1[..., None] * fac.a + me2[..., None] * fac.b).sum(dim=-2)
    return M, rhs << 3
