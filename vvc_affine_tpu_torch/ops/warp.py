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
* ``staging_plan``, ``warp_staged`` and ``filter_blocks_dp2a``: plain
  mirrors of the kernel's design (the reference region each 32-row strip
  stages, the rule that sends a block to the global path, and the filter
  as two-way dot products of int16 pairs and int8 taps), which the tests
  hold against ``warp_xla`` and ``filter_blocks``.

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

# K1's staging (csrc/warp.cu): a thread block takes a STRIP-row strip of a
# CTU in ``group_bins`` consecutive bins and stages RH x RW reference
# samples around the displacement of the strip's centre block in the
# group's first bin, MY rows and MX columns of margin
STRIP = 32
MY = 6
RH = STRIP + 5 + 2 * MY
RW = 160
MX = (RW - 128 - 5) // 2

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


def _dp2a(a, b, acc, hi: bool):
    """``__dp2a_lo`` / ``__dp2a_hi``: acc + the two signed 16-bit halves of
    a times signed bytes 0, 1 (lo) or 2, 3 (hi) of b."""
    def s16(x):
        return ((x & 0xFFFF) ^ 0x8000) - 0x8000

    def s8(x):
        return ((x & 0xFF) ^ 0x80) - 0x80
    b = b >> 16 if hi else b
    return acc + s16(a) * s8(b) + s16(a >> 16) * s8(b >> 8)


def _packed_taps(taps, shift):
    """int8 taps [..., 6] at bytes shift .. shift + 5 of 8 (zeros around),
    as the two words (bytes 0-3, 4-7) K1 keeps per phase and shift."""
    pos = shift[..., None] + torch.arange(6)
    b = torch.zeros(taps.shape[:-1] + (8,), dtype=torch.int64)
    b = b.scatter(-1, pos, taps.to(torch.int64) & 0xFF)
    sh = 8 * torch.arange(4)
    return ((b[..., :4] << sh).sum(-1), (b[..., 4:] << sh).sum(-1))


def filter_blocks_dp2a(win, hc, vc, par):
    """``filter_blocks`` as K1 computes it with two-way dot products.

    The window's row is held as five words of int16 sample pairs from
    column -par on (par 0 or 1, per block: the parity of the window in the
    staged row; the sample outside the window gets a zero tap); each 6-tap
    sum is four dp2a against the taps shifted by the start's parity, and
    the vertical pass pairs intermediate rows (2k, 2k + 1) in one word.
    win: 10-bit samples [..., 9, 9]; hc/vc: [..., 6]; par: int [...].
    """
    w = win.to(torch.int64)
    par = torch.as_tensor(par, dtype=torch.int64).expand(w.shape[:-2])
    pad = torch.full(w.shape[:-1] + (1,), 1023, dtype=torch.int64)
    row = torch.where(par[..., None, None] == 0, torch.cat([w, pad], -1),
                      torch.cat([pad, w], -1))                # [..., 9, 10]
    words = [row[..., 2 * q] | row[..., 2 * q + 1] << 16 for q in range(5)]
    te = _packed_taps(hc, par)
    to = _packed_taps(hc, par + 1)
    tmp = []
    for c in range(4):
        b = c >> 1
        t0, t1 = ((to if c & 1 else te)[i][..., None] for i in (0, 1))
        acc = torch.full_like(words[0], _OFF1)
        acc = _dp2a(words[b], t0, acc, False)
        acc = _dp2a(words[b + 1], t0, acc, True)
        acc = _dp2a(words[b + 2], t1, acc, False)
        acc = _dp2a(words[b + 3], t1, acc, True)
        tmp.append(acc >> _SHIFT1)                            # [..., 9]
    tmp = torch.stack(tmp, -1)                                # [..., 9, 4]
    pairs = [(tmp[..., 2 * k, :] & 0xFFFF)
             | ((tmp[..., 2 * k + 1, :] & 0xFFFF) << 16 if k < 4 else 0)
             for k in range(5)]                               # [..., 4]
    zero = torch.zeros(par.shape, dtype=torch.int64)
    ve, vo = _packed_taps(vc, zero), _packed_taps(vc, zero + 1)
    rows = []
    for o in range(4):
        t = vo if o & 1 else ve
        acc = torch.full_like(pairs[0], _OFF2)
        for j in range(4 if o & 1 else 3):
            acc = _dp2a(pairs[(o >> 1) + j], t[j >> 1][..., None], acc,
                        bool(j & 1))
        rows.append(acc >> _SHIFT2)
    out = torch.stack(rows, dim=-2)                           # [..., 4, 4]
    return clamp(out, C.CLP_RNG_MIN, C.CLP_RNG_MAX).to(torch.int32)


def group_bins(n_bins: int) -> int:
    """Bins per K1 thread block: half of them, rounded up."""
    return (n_bins + 1) // 2


def staging_plan(ctu_y, ctu_x, dy, dx):
    """K1's staged regions and the blocks that read them.

    Returns (ry0, rx0) int32 [nCtu, nBins, 4], the frame coordinates of
    the staged region each strip of each bin reads (RH x RW samples,
    clamped to the frame when read; shared by the ``group_bins`` bins of a
    group),
    and ``staged`` bool [nCtu, nBins, NB, NB]: True where the block's 9x9
    window lies inside its strip's region; the others read global memory.
    """
    n_ctu, n_bins = dy.shape[:2]
    g = group_bins(n_bins)
    first = torch.arange(n_bins, device=dy.device) // g * g
    cy = dy.reshape(n_ctu, n_bins, 4, 8, NB)[:, first, :, 4, 16]
    cx = dx.reshape(n_ctu, n_bins, 4, 8, NB)[:, first, :, 4, 16]
    strip0 = STRIP * torch.arange(4, dtype=torch.int32, device=dy.device)
    ry0 = ctu_y[:, None, None] + strip0 + cy - 2 - MY
    rx0 = ctu_x[:, None, None] + cx - 2 - MX
    blk = 4 * torch.arange(NB, dtype=torch.int32, device=dy.device)
    wy = ((blk % STRIP)[:, None] + dy).reshape(n_ctu, n_bins, 4, 8, NB) \
        - cy[..., None, None] + MY
    wx = (blk + dx).reshape(n_ctu, n_bins, 4, 8, NB) \
        - cx[..., None, None] + MX
    staged = (wy >= 0) & (wy <= RH - 9) & (wx >= 0) & (wx <= RW - 9)
    return ry0, rx0, staged.reshape(n_ctu, n_bins, NB, NB)


def warp_staged(ref_flat, frame_w: int, frame_h: int, ctu_y, ctu_x,
                dy, dx, hc, vc):
    """``warp_xla`` through K1's data flow: each strip's region staged with
    clamped coordinates, staged blocks' windows read from it, the others
    from the frame with clamped coordinates (``staging_plan``)."""
    n_ctu, n_bins = dy.shape[:2]
    dev = ref_flat.device
    ry0, rx0, staged = staging_plan(ctu_y, ctu_x, dy, dx)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=dev)
    ys = clamp(ry0[..., None] + ar(RH), 0, frame_h - 1)   # [.., 4, RH]
    xs = clamp(rx0[..., None] + ar(RW), 0, frame_w - 1)   # [.., 4, RW]
    region = ref_flat[(ys[..., :, None] * frame_w
                       + xs[..., None, :]).long()]        # [.., 4, RH, RW]
    # window origins: in the region, and in the frame
    by = 4 * ar(NB)[:, None].expand(NB, NB)
    bx = 4 * ar(NB)[None, :].expand(NB, NB)
    strip = (by // STRIP).expand(n_ctu, n_bins, NB, NB)
    wy = by + dy - ry0.gather(2, strip.reshape(n_ctu, n_bins, -1)) \
        .reshape(strip.shape) + ctu_y[:, None, None, None] - 2
    wx = bx + dx - rx0.gather(2, strip.reshape(n_ctu, n_bins, -1)) \
        .reshape(strip.shape) + ctu_x[:, None, None, None] - 2
    taps = ar(9)
    ry = clamp(wy[..., None] + taps, 0, RH - 1)
    rx = clamp(wx[..., None] + taps, 0, RW - 1)
    flat = region.reshape(n_ctu, n_bins, 4 * RH * RW)
    ridx = (strip[..., None, None] * RH + ry[..., :, None]) * RW \
        + rx[..., None, :]                              # [.., NB, NB, 9, 9]
    from_region = flat.gather(2, ridx.reshape(n_ctu, n_bins, -1).long()) \
        .reshape(ridx.shape)
    gy = clamp(ctu_y[:, None, None, None] + by + dy - 2, -2 ** 30, 2 ** 30)
    gx = clamp(ctu_x[:, None, None, None] + bx + dx - 2, -2 ** 30, 2 ** 30)
    gys = clamp(gy[..., None] + taps, 0, frame_h - 1)
    gxs = clamp(gx[..., None] + taps, 0, frame_w - 1)
    from_frame = ref_flat[(gys[..., :, None] * frame_w
                           + gxs[..., None, :]).long()]
    win = torch.where(staged[..., None, None], from_region, from_frame)
    pred = filter_blocks(win, torch.movedim(hc, 2, -1),
                         torch.movedim(vc, 2, -1))      # [.., NB, NB, 4, 4]
    return pred.transpose(3, 4).reshape(n_ctu, n_bins, 128, 128)


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
    """K1 bound to CUDA inputs (``warp``'s contract; the kernel packs
    reference samples as int16 pairs, so they must lie in [0, 1023], which
    every entry point that takes frames enforces with
    ``runtime.frames.check_samples``): returns the output tensor and a
    callable that launches the kernel into it."""
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
