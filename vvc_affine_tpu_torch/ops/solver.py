"""Batched VTM least-squares solver and CPMV delta scaling.

Behavioural spec: affine.cl:782-915 — VTM-12.0 solveEqual() (float64 Gaussian
elimination with column-max pivoting, no early return) followed by the affine
parameter -> quarter-pel delta-MV conversion of scaleDeltaMvs
(aux_functions.cl:2194-2215) and the dDeltaMv composition (affine.cl:858-869).

The elimination runs eagerly in float64 over the CU batch with static loops
over the (tiny) parameter dimension.  Floating-point operation ORDER matches
the reference exactly (multiply-then-divide per element; ordered
back-substitution sums), and every multiply, divide and add is its own eager
op, so no multiply-add is ever contracted into a fused multiply-add: results
are bit-identical on the CPU and on the card.  Keep this out of hand-written
kernels (nvcc contracts by default, ``-fmad=true``).
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import constants as C


def solve_affine(M, rhs, n_cp: int):
    """Solve the per-CU systems.

    M: int64 [..., P, P]; rhs: int64 [..., P]; P = 2*n_cp.
    Returns float64 dAffinePara [..., P].

    Layout note: the reference's dEqualCoeff row r (1-based, r=1..P) is our
    row r-1; its columns 0..P-1 are the matrix (M[q][p] at column p of row
    q+1) and column P the rhs.
    """
    P = 2 * n_cp
    dev = M.device
    B = torch.cat(
        [M.to(torch.float64), rhs.to(torch.float64)[..., None]], dim=-1
    )  # [..., P, P+1]

    row_ids = torch.arange(P, device=dev)
    col_ids = torch.arange(P + 1, device=dev)
    # forward elimination (reference i = 1..P-1; pivot row r0 = i-1, col i-1)
    for i in range(1, P):
        r0 = i - 1
        col = B[..., :, i - 1].abs()  # [..., P]
        # candidates are rows r0.. (ref scans j=i+1..P with init j=i)
        cand = torch.where(row_ids >= r0, col, float("-inf"))
        # ref keeps the FIRST max only when strictly greater than earlier
        # candidates == first index of the max; torch.argmax returns the
        # first occurrence and counts NaN as the max, like the reference
        amax = torch.argmax(cand, dim=-1)  # [...]
        # swap rows r0 <-> amax as one-hot selects: the one-hot sum maps a
        # -0.0 pivot-row entry to +0.0 exactly as the JAX engine does
        amax_oh = row_ids == amax[..., None]  # [..., P] one-hot
        B_amax = torch.where(amax_oh[..., None], B, 0.0).sum(dim=-2)
        B_r0 = B[..., r0, :]
        is_r0 = (row_ids == r0)[:, None]
        B = torch.where(
            is_r0,
            B_amax[..., None, :],
            torch.where(amax_oh[..., None], B_r0[..., None, :], B),
        )
        # eliminate rows r > r0, columns k >= i
        pivot_row = B[..., r0, :]  # [..., P+1]
        pivot = B[..., r0, i - 1]  # [...]
        lead = B[..., :, i - 1]  # [..., P]
        upd = B - (pivot_row[..., None, :] * lead[..., :, None]) / pivot[..., None, None]
        row_mask = (row_ids > r0)[:, None]
        col_mask = (col_ids >= i)[None, :]
        B = torch.where(row_mask & col_mask, upd, B)

    # back substitution (reference affine.cl:834-855)
    x = [None] * P
    x[P - 1] = B[..., P - 1, P] / B[..., P - 1, P - 1]
    dead = torch.zeros(B.shape[:-2], dtype=torch.bool, device=dev)
    for i in range(P - 2, -1, -1):
        dead = dead | (B[..., i, i] == 0.0)
        temp = torch.zeros(B.shape[:-2], dtype=torch.float64, device=dev)
        for j in range(i + 1, P):
            temp = temp + B[..., i, j] * x[j]
        x[i] = (B[..., i, P] - temp) / B[..., i, i]
    params = torch.stack(x, dim=-1)
    return torch.where(dead[..., None], 0.0, params)


def scale_delta_mvs(params, n_cp: int, cu_w, cu_h):
    """dAffinePara -> int32 CPMV deltas [..., 3, 2] ((LT,RT,LB) x (x,y)).

    cu_w/cu_h: int32 [...] CU dimensions.  Implements the dDeltaMv
    composition (affine.cl:858-869), scaleDeltaMvs' truncate-toward-zero
    quarter-pel rounding (aux:2203-2210), and the s0..s5 -> CPMV mapping
    (affine.cl:884-889).  NaN parameters (degenerate systems whose zero-pivot
    path did not trigger) convert to 0, matching GPU float-to-int semantics.
    """
    w = cu_w.to(torch.float64)
    h = cu_h.to(torch.float64)
    p = params
    d0 = p[..., 0]
    d2 = p[..., 2]
    d1 = p[..., 1] * w + p[..., 0]
    if n_cp == 3:
        d3 = p[..., 3] * w + p[..., 2]
        d4 = p[..., 4] * h + p[..., 0]
        d5 = p[..., 5] * h + p[..., 2]
    else:
        d3 = -p[..., 3] * w + p[..., 2]
        d4 = torch.zeros_like(d0)
        d5 = torch.zeros_like(d0)

    mult = 1 << (C.AFFINE_MV_PRECISION_QUARTER - C.AFFINE_MV_PRECISION_INT)  # 4
    mv_shift = C.MV_PRECISION_INTERNAL - C.AFFINE_MV_PRECISION_QUARTER  # 2

    def quantise(d):
        half = (d >= 0).to(torch.float64) - 0.5     # SIGN(x>=0)=+1: +-0.5
        v = d * mult + half
        v = torch.where(torch.isnan(v), 0.0,
                        torch.clamp(v, -(2.0**31), 2.0**31 - 1))
        return torch.trunc(v).to(torch.int32) << mv_shift

    # s0->LT.x, s1(=f(d2))->LT.y, s2(=f(d1))->RT.x, s3->RT.y, s4->LB.x, s5->LB.y
    lt = torch.stack([quantise(d0), quantise(d2)], dim=-1)
    rt = torch.stack([quantise(d1), quantise(d3)], dim=-1)
    lb = torch.stack([quantise(d4), quantise(d5)], dim=-1)
    return torch.stack([lt, rt, lb], dim=-2)
