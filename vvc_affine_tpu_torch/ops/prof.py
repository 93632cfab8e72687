"""PROF — Prediction Refinement with Optical Flow (optional path).

Port of the JAX package's ``ops/prof.py``.  Behavioural spec:
aux_functions.cl:218-400 (per-sub-block delta-MV fields), :409-468
(padded-block gradients) and :472-605 (the PROF correction).  The reference
computes the deltas every iteration but hard-disables the refinement
(enablePROF=0, affine.cl:168/1132), so the gather engine does not call this
module; it completes the ops layer for enablePROF=1 workloads.

All arithmetic int32-exact; deltas need only the per-CU affine deltas, so
they are uniform across sub-blocks of a CU.
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch.ops.mv import affine_deltas
from vvc_affine_tpu_torch.utils.bitmath import clamp, round_shift

_MV_SHIFT = 8
_DMV_LIMIT = (1 << 5) - 1


def prof_delta_fields(cpmvs, log2w: int, log2h: int, n_cp: int):
    """Per-sample delta-MV fields of the 4x4 sub-block (same for every
    sub-block of a CU).

    cpmvs: int32 [..., 3, 2].  Returns (d_hor, d_ver) int32 [..., 16].
    """
    hx, hy, vx, vy = affine_deltas(cpmvs, log2w, log2h, n_cp)
    idx = torch.arange(4, dtype=torch.int32, device=cpmvs.device)

    def field(h_step, v_step):
        quad_h = h_step << 2
        quad_v = v_step << 2
        base = ((h_step + v_step) << 1) - ((quad_h + quad_v) << 1)
        d = (
            base[..., None, None]
            + quad_h[..., None, None] * idx[None, :]
            + quad_v[..., None, None] * idx[:, None]
        )
        d = round_shift(d.reshape(d.shape[:-2] + (16,)), _MV_SHIFT)
        return clamp(d, -_DMV_LIMIT, _DMV_LIMIT)

    return field(hx, vx), field(hy, vy)


def apply_prof(pred, windows, x_frac, y_frac, d_hor, d_ver):
    """PROF correction of predicted 4x4 sub-blocks (aux:472-605).

    pred: int32 [..., 16] at 14-bit internal precision (the isLast=false
    vertical-filter output, interp.filter_windows(last=False));
    windows: int32 [..., 11, 11] reference windows; x_frac/y_frac [...];
    d_hor/d_ver: int32 [..., 16].  Returns clipped int32 [..., 16].
    """
    # 6x6 padded block: inner 4x4 = pred; border from the (rescaled)
    # reference window around the nearest-integer sample.  The window
    # anchor of the reference 4x4 is (3, 3); the offsets are 0/1, so select
    # among the four statically sliced 6x6 neighbourhoods.
    sel = ((y_frac >> 3) * 2 + (x_frac >> 3))[..., None, None]
    variants = [windows[..., 2 + yo:8 + yo, 2 + xo:8 + xo]
                for yo in (0, 1) for xo in (0, 1)]
    gathered = torch.where(
        sel == 0, variants[0],
        torch.where(sel == 1, variants[1],
                    torch.where(sel == 2, variants[2], variants[3])))
    padded = (gathered << 4) - C.IF_INTERNAL_OFFS
    padded[..., 1:5, 1:5] = pred.reshape(pred.shape[:-1] + (4, 4))

    shift1 = 6
    gx = (padded[..., 1:5, 2:6] >> shift1) - (padded[..., 1:5, 0:4] >> shift1)
    gy = (padded[..., 2:6, 1:5] >> shift1) - (padded[..., 0:4, 1:5] >> shift1)
    gx = gx.reshape(gx.shape[:-2] + (16,))
    gy = gy.reshape(gy.shape[:-2] + (16,))

    limit = 1 << 13
    delta_i = clamp(gx * d_hor + gy * d_ver, -limit, limit - 1)
    shift_num = 4
    offset = (1 << (shift_num - 1)) + C.IF_INTERNAL_OFFS
    out = (pred + delta_i + offset) >> shift_num
    return clamp(out, C.CLP_RNG_MIN, C.CLP_RNG_MAX)
