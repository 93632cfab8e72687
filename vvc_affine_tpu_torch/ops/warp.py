"""Dense motion-compensated prediction of whole CTU planes (kernel K1).

For each (CTU, bin) the engine predicts one 128x128 plane: every 4x4 block
is displaced by its own integer motion (dy, dx) and filtered by the VTM
1/16-pel separable filter of its own phase (fx, fy) — the reference's
per-sub-block window fetch + 8-tap interpolation (affine.cl:254-393,
aux_functions.cl:1096-1223).

* ``warp_xla``: the plain PyTorch version — clamped window gather +
  separable filter, exact for ANY displacement (the port of the JAX
  package's ``ops/warp.warp_xla``).
* ``warp``: the wrapper the engine calls.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/warp.cu``; on a CPU tensor it runs the plain
  version.  Both return int16 planes (samples are 10-bit after the clip).

Bit-exactness: both reproduce VTM's first/last-pass offset/shift scheme in
int32 (aux_functions.cl:1121-1195), and the window clamp equals the
reference's per-sample clamp-to-edge correction (affine.cl:288-326).

6-tap convention: the VTM 4x4 affine filter bank (m_lumaFilter4x4,
constants.cl:40-58) has ZERO first and last taps in every one of its 16
phases, so the nominal 8-tap filter is effectively 6-tap: taps are bank
columns 1..6 and each block reads a 9x9 window starting 2 samples above and
left of its displaced corner.
"""

from __future__ import annotations

import numpy as np
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.utils.bitmath import clamp

NB = 32      # 4x4 block slots per CTU axis

_SHIFT1 = C.IF_FILTER_PREC - 4                    # 2
_OFF1 = -C.IF_INTERNAL_OFFS << _SHIFT1
_SHIFT2 = C.IF_FILTER_PREC + 4                    # 10
_OFF2 = (1 << (_SHIFT2 - 1)) + (C.IF_INTERNAL_OFFS << C.IF_FILTER_PREC)

# bank columns 1..6 of every phase (columns 0 and 7 are zero)
BANK6 = np.asarray(C.LUMA_FILTER_4x4, np.int16)[:, 1:7]     # [16, 6]
assert not C.LUMA_FILTER_4x4[:, [0, 7]].any()


def tap_planes(f: torch.Tensor) -> torch.Tensor:
    """Phase plane [..., NB, NB] -> int16 taps [..., 6, NB, NB].

    The 6 non-zero coefficients of each block's filter phase (coefficients
    are in [-11, 63], so int16 holds them and every consumer promotes
    exactly in the multiply).
    """
    bank = torch.as_tensor(BANK6, device=f.device)
    return torch.movedim(bank[f.long()], -1, -3)


def filter_blocks(win, hc, vc):
    """Separable 6-tap over 9x9 windows with explicit per-block taps.

    win: int32 [..., 9, 9] starting at displacement offset -2 (see
    warp_xla); hc/vc: int16/int32 [..., 6] (filter-bank columns 1..6).
    Returns int32 [..., 4, 4] clipped to [0, 1023].
    """
    cols = []
    for c in range(4):
        acc = win[..., :, c] * hc[..., None, 0]
        for t in range(1, 6):
            acc = acc + win[..., :, c + t] * hc[..., None, t]
        cols.append((acc + _OFF1) >> _SHIFT1)
    tmp = torch.stack(cols, dim=-1)                      # [..., 9, 4]
    rows = []
    for r in range(4):
        acc = tmp[..., r, :] * vc[..., None, 0]
        for t in range(1, 6):
            acc = acc + tmp[..., r + t, :] * vc[..., None, t]
        rows.append((acc + _OFF2) >> _SHIFT2)
    out = torch.stack(rows, dim=-2)                      # [..., 4, 4]
    return clamp(out, C.CLP_RNG_MIN, C.CLP_RNG_MAX)


def warp_xla(ref_flat, frame_w: int, frame_h: int, ctu_y, ctu_x,
             dy, dx, hc, vc):
    """Exact dense warp via clamped gather; any displacement.

    ref_flat: int32 [fh*fw]; ctu_y/ctu_x: int32 [nCtu] CTU corners;
    dy/dx: int32 [nCtu, nCls, NB, NB]; hc/vc: int16/int32
    [nCtu, nCls, 6, NB, NB] (6-tap convention, see module docstring).
    Returns int32 [nCtu, nCls, 128, 128].
    """
    n_ctu, n_cls = dy.shape[:2]
    dev = ref_flat.device
    taps = torch.arange(9, dtype=torch.int32, device=dev)
    blk = 4 * torch.arange(NB, dtype=torch.int32, device=dev)
    planes = []
    for ci in range(n_cls):
        by = ctu_y[:, None, None] + blk[:, None]
        bx = ctu_x[:, None, None] + blk[None, :]
        y0 = by + dy[:, ci] - 2
        x0 = bx + dx[:, ci] - 2
        ys = clamp(y0[..., None] + taps, 0, frame_h - 1)
        xs = clamp(x0[..., None] + taps, 0, frame_w - 1)
        idx = ys[..., :, None] * frame_w + xs[..., None, :]
        win = ref_flat[idx.long()]                       # [nCtu, NB, NB, 9, 9]
        hcc = torch.movedim(hc[:, ci], 1, -1)            # [nCtu, NB, NB, 6]
        vcc = torch.movedim(vc[:, ci], 1, -1)
        pred = filter_blocks(win, hcc, vcc)              # [nCtu, NB, NB, 4, 4]
        planes.append(pred.transpose(2, 3).reshape(n_ctu, 128, 128))
    return torch.stack(planes, dim=1)


def warp(ref_flat, frame_w: int, frame_h: int, ctu_y, ctu_x, dy, dx, fx, fy,
         slab_active):
    """Predict every (CTU, bin) plane: int16 [nCtu, nBins, 128, 128].

    ref_flat: int32 [fh*fw]; ctu_y/ctu_x: int32 [nCtu]; dy/dx (integer
    displacements) and fx/fy (1/16-pel phases in [0, 16)): int32
    [nCtu, nBins, NB, NB]; slab_active: int32 [nCtu, nBins, 16] — the
    kernel skips 8-row slabs whose entry is 0, and their output rows are
    unspecified (``affine_plane.slab_activity``: no in-frame CU of the bin
    covers them, so every consumer masks them).  A CUDA ``ref_flat``
    launches the K1 kernel (csrc/warp.cu); a CPU one runs ``warp_xla`` on
    the looked-up taps, over every slab.
    """
    if ref_flat.device.type == "cpu":
        return warp_xla(ref_flat, frame_w, frame_h, ctu_y, ctu_x, dy, dx,
                        tap_planes(fx), tap_planes(fy)).to(torch.int16)
    out, run = bind_warp(ref_flat, frame_w, frame_h, ctu_y, ctu_x, dy, dx,
                         fx, fy, slab_active)
    run()
    return out


def bind_warp(ref_flat, frame_w: int, frame_h: int, ctu_y, ctu_x, dy, dx,
              fx, fy, slab_active):
    """K1 bound to CUDA inputs (``warp``'s contract): returns the output
    tensor and a callable that launches the kernel into it."""
    n_ctu, n_bins = dy.shape[:2]
    kernels.check(ref_flat, torch.int32, (frame_h * frame_w,), "ref_flat")
    kernels.check(ctu_y, torch.int32, (n_ctu,), "ctu_y", ref_flat.device)
    kernels.check(ctu_x, torch.int32, (n_ctu,), "ctu_x", ref_flat.device)
    for name, t in (("dy", dy), ("dx", dx), ("fx", fx), ("fy", fy)):
        kernels.check(t, torch.int32, (n_ctu, n_bins, NB, NB), name,
                      ref_flat.device)
    kernels.check(slab_active, torch.int32, (n_ctu, n_bins, 16),
                  "slab_active", ref_flat.device)
    out = torch.empty((n_ctu, n_bins, 128, 128), dtype=torch.int16,
                      device=ref_flat.device)
    return out, kernels.bind("warp", out.device, out, ref_flat, ctu_y, ctu_x,
                             dy, dx, fx, fy, slab_active, frame_w, frame_h,
                             n_ctu, n_bins)
