"""Batched motion-vector derivation, rounding, and clipping.

Behavioural spec: aux_functions.cl:37-212 (roundMv/clipMv/deriveMv*Cps) and
affine.cl:83-105 (3CP LB predictor derivation).  All functions are elementwise
over arbitrary leading batch dims; int32 in/out.
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch.utils.bitmath import clamp, round_shift

_DERIVE_SHIFT = C.MAX_CU_DEPTH - 4 + C.MV_FRACTIONAL_BITS_INTERNAL  # = 7


def clip_mv(mvx, mvy, block_x, block_y, frame_w: int, frame_h: int):
    """clipMvInPic analogue (aux_functions.cl:51-67)."""
    s = C.MV_FRACTIONAL_BITS_INTERNAL
    off = 8
    hor_max = (frame_w + off - block_x - 1) << s
    hor_min = (-C.MAX_CU_WIDTH - off - block_x + 1) << s
    ver_max = (frame_h + off - block_y - 1) << s
    ver_min = (-C.MAX_CU_HEIGHT - off - block_y + 1) << s
    return clamp(mvx, hor_min, hor_max), clamp(mvy, ver_min, ver_max)


def round_and_clip_mv(mvx, mvy, pu_x, pu_y, frame_w: int, frame_h: int):
    """roundMv(shift=7) + clipMv (aux_functions.cl:90-101)."""
    return clip_mv(
        round_shift(mvx, _DERIVE_SHIFT),
        round_shift(mvy, _DERIVE_SHIFT),
        pu_x,
        pu_y,
        frame_w,
        frame_h,
    )


def is_spread_over_limit(a, b, c, d):
    """isSubblockVectorSpreadOverLimit, uni-pred branch (aux:106-141)."""
    s4 = 4 << 11
    tap = 6
    zero = torch.zeros_like(a)
    rw = torch.maximum(zero, 4 * a + s4) - torch.minimum(zero, 4 * a + s4)
    rh = torch.maximum(zero, 4 * b) - torch.minimum(zero, 4 * b)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    spread1 = rw * rh > (tap + 9) * (tap + 5)
    rw = torch.maximum(zero, 4 * c) - torch.minimum(zero, 4 * c)
    rh = torch.maximum(zero, 4 * d + s4) - torch.minimum(zero, 4 * d + s4)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    spread2 = rw * rh > (tap + 5) * (tap + 9)
    return spread1 | spread2


def affine_deltas(cpmvs, log2w: int, log2h: int, n_cp: int):
    """Per-CU affine motion deltas (aux:152-191).

    cpmvs: int32 [..., 3, 2] (LT, RT, LB) x (x, y).
    Returns (hx, hy, vx, vy) each [...].
    """
    lt = cpmvs[..., 0, :]
    rt = cpmvs[..., 1, :]
    hx = (rt[..., 0] - lt[..., 0]) << (_DERIVE_SHIFT - log2w)
    hy = (rt[..., 1] - lt[..., 1]) << (_DERIVE_SHIFT - log2w)
    if n_cp == 3:
        lb = cpmvs[..., 2, :]
        vx = (lb[..., 0] - lt[..., 0]) << (_DERIVE_SHIFT - log2h)
        vy = (lb[..., 1] - lt[..., 1]) << (_DERIVE_SHIFT - log2h)
    else:
        vx = -hy
        vy = hx
    return hx, hy, vx, vy


def derive_sub_mvs(cpmvs, log2w: int, log2h: int, n_cp: int, sub_x, sub_y):
    """Raw per-sub-block MVs for every CU (deriveMv{2,3}Cps_and_spread).

    cpmvs: int32 [..., 3, 2]; sub_x/sub_y: int32 [S] sub-block corners
    (CU-relative).  Returns (mvx, mvy, spread): mv* [..., S], spread [...].
    """
    hx, hy, vx, vy = affine_deltas(cpmvs, log2w, log2h, n_cp)
    spread = is_spread_over_limit(hx, hy, vx, vy)
    base_x = cpmvs[..., 0, 0] << _DERIVE_SHIFT
    base_y = cpmvs[..., 0, 1] << _DERIVE_SHIFT
    w_half = 1 << (log2w - 1)
    h_half = 1 << (log2h - 1)
    cx = torch.where(spread[..., None], w_half, sub_x + 2)
    cy = torch.where(spread[..., None], h_half, sub_y + 2)
    mvx = base_x[..., None] + hx[..., None] * cx + vx[..., None] * cy
    mvy = base_y[..., None] + hy[..., None] * cx + vy[..., None] * cy
    return mvx, mvy, spread


def round_affine_prec_quarter(v):
    """roundAffinePrecInternal2Amvr(mv, QUARTER) (aux:2078-2113).

    src=6, dst=4: round at quarter-pel, re-express at 1/16-pel.
    """
    off = 2  # 1 << (rightShift - 1), rightShift = 2
    r = torch.where(v >= 0, (v + off - 1) >> 2, (v + off) >> 2)
    return r << 2


def change_precision_to_quarter(v):
    """changeAffinePrecInternal2Amvr(mv, QUARTER) (aux:2057-2075)."""
    off = 2
    return torch.where(v >= 0, (v + off - 1) >> 2, (v + off) >> 2)


def derive_lb_from_2cp(cpmvs_2cp, log2w: int, log2h: int, cu_x, cu_y,
                       frame_w: int, frame_h: int):
    """3CP initial LB from a 2CP result (affine.cl:83-105).

    cpmvs_2cp: int32 [..., 3, 2]; cu_x/cu_y absolute CU corners [...].
    Returns int32 [..., 2] LB.
    """
    shift = C.MAX_CU_DEPTH
    lt = cpmvs_2cp[..., 0, :]
    rt = cpmvs_2cp[..., 1, :]
    rot = shift + log2h - log2w
    vx2 = (lt[..., 0] << shift) - ((rt[..., 1] - lt[..., 1]) << rot)
    vy2 = (lt[..., 1] << shift) + ((rt[..., 0] - lt[..., 0]) << rot)
    offset = 1 << (shift - 1)
    vx2 = (vx2 + offset - (vx2 >= 0).to(vx2.dtype)) >> shift
    vy2 = (vy2 + offset - (vy2 >= 0).to(vy2.dtype)) >> shift
    vx2 = clamp(vx2, -(1 << 17), (1 << 17) - 1)
    vy2 = clamp(vy2, -(1 << 17), (1 << 17) - 1)
    vx2 = round_affine_prec_quarter(vx2)
    vy2 = round_affine_prec_quarter(vy2)
    vx2, vy2 = clip_mv(vx2, vy2, cu_x, cu_y, frame_w, frame_h)
    return torch.stack([vx2, vy2], dim=-1)
