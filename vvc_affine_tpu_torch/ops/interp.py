"""Motion-compensated 4x4 sub-block prediction: window gather + 8-tap filter.

Port of the JAX package's ``ops/interp.py`` (the gather engine's
prediction).  Behavioural spec:

  * window fetch with 8-way out-of-frame correction (affine.cl:254-326) —
    equivalent to clamp-to-edge sample indexing, realised as one clamped
    gather from the flat reference plane;
  * separable 1/16-pel 8-tap interpolation with VTM's first/last-pass
    offset/shift scheme (aux_functions.cl:1096-1223).

Exactness: the horizontal pass sums |coef|*1023 <= 2^17 and the vertical
pass <= 2^23, so int32 arithmetic is exact and the order of the tap sums
does not matter; every sum is taken in int32 (``sum`` would widen to int64)
and shifts on signed int32 are arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch.utils.bitmath import clamp

_SHIFT1 = C.IF_FILTER_PREC - 4  # 2; first-pass shift
_OFF1 = -C.IF_INTERNAL_OFFS << _SHIFT1
_SHIFT2 = C.IF_FILTER_PREC + 4  # 10; last-pass shift
_OFF2 = (1 << (_SHIFT2 - 1)) + (C.IF_INTERNAL_OFFS << C.IF_FILTER_PREC)


@functools.lru_cache(maxsize=None)
def _bank(device: torch.device) -> torch.Tensor:
    """The 16-phase 8-tap filter bank, int32 [16, 8], once per device."""
    return torch.as_tensor(np.asarray(C.LUMA_FILTER_4x4, np.int32),
                           device=device)


def _clamped_index(x0, y0, n: int, frame_w: int, frame_h: int):
    """int64 flat indices [..., n, n] of the n x n window at (x0, y0),
    every coordinate clamped into the frame."""
    taps = torch.arange(n, dtype=torch.int32, device=x0.device)
    xs = clamp(x0[..., None] + taps, 0, frame_w - 1)  # [..., n]
    ys = clamp(y0[..., None] + taps, 0, frame_h - 1)
    return (ys[..., :, None] * frame_w + xs[..., None, :]).to(torch.int64)


def gather_windows(ref_flat, frame_w: int, frame_h: int, bx, by, mv_int_x,
                   mv_int_y):
    """Clamped 11x11 reference windows.

    ref_flat: int32 [frame_h*frame_w]; bx/by: absolute sub-block corners
    [...]; mv_int_*: integer-pel MV parts [...].
    Returns int32 [..., 11, 11].
    """
    x0 = bx + mv_int_x - (C.NTAPS_LUMA // 2 - 1)
    y0 = by + mv_int_y - (C.NTAPS_LUMA // 2 - 1)
    return torch.take(ref_flat, _clamped_index(x0, y0, 11, frame_w, frame_h))


def filter_windows(windows, x_frac, y_frac, last: bool = True):
    """Separable 8-tap over 11x11 windows -> 4x4 predictions.

    windows: int32 [..., 11, 11]; x_frac/y_frac: int32 [...] in [0, 15].
    Returns int32 [..., 16] (row-major 4x4).  With ``last`` (the shipping
    path) the result is scaled back to sample range and clipped to
    [0, 1023]; with ``last=False`` it stays at the 14-bit internal
    precision (the vertical-pass isLast=false branch, aux:1185-1195, used
    when PROF follows).
    """
    bank = _bank(windows.device)
    hcoef = bank[x_frac.to(torch.int64)]  # [..., 8]
    vcoef = bank[y_frac.to(torch.int64)]
    # horizontal pass: rows 0..10, output cols 0..3, taps on the last axis
    acc = (windows.unfold(-1, 8, 1) * hcoef[..., None, None, :]).sum(
        -1, dtype=torch.int32)                      # [..., 11, 4]
    tmp = (acc + _OFF1) >> _SHIFT1
    # vertical pass: output rows 0..3 (unfolded rows r..r+7), cols 0..3
    shift2, off2 = (_SHIFT2, _OFF2) if last else (C.IF_FILTER_PREC, 0)
    acc = (tmp.unfold(-2, 8, 1) * vcoef[..., None, None, :]).sum(
        -1, dtype=torch.int32)                      # [..., 4, 4]
    out = (acc + off2) >> shift2
    if last:
        out = clamp(out, C.CLP_RNG_MIN, C.CLP_RNG_MAX)
    return out.reshape(out.shape[:-2] + (16,))


def predict_subblocks(ref_flat, frame_w: int, frame_h: int, bx, by, mvx, mvy):
    """Full MC prediction from rounded+clipped 1/16-pel MVs.

    mvx/mvy: int32 [...] (post roundAndClipMv).  Returns int32 [..., 16].
    """
    win = gather_windows(ref_flat, frame_w, frame_h, bx, by, mvx >> 4,
                         mvy >> 4)
    return filter_windows(win, mvx & 15, mvy & 15)


def gather_blocks(plane_flat, frame_w: int, frame_h: int, bx, by):
    """4x4 blocks at absolute corners (bx, by), clamped indices.

    Returns int32 [..., 16].
    """
    vals = torch.take(plane_flat, _clamped_index(bx, by, 4, frame_w, frame_h))
    return vals.reshape(vals.shape[:-2] + (16,))
