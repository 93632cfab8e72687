"""The least work of the two hand-written kernels, counted from the
algorithm, and the H100's published peaks.

The counts read only the frame size, the CU classes (``geometry``) and the
iteration counts, never a table or layout of the program, so they count
the same work whatever implements it:

* K1, the warp, predicts every sample of every in-frame CU of every class
  of the mode once per evaluate whose CPMVs are not all zero: the 2CP
  stage's evaluates 1..5 (evaluate 0, at zero motion, is the phase-0
  filter, an identity) and all five of the 3CP stage, so 10 per mode and
  frame-ref.  Each sample costs at least the 6 + 6 taps of the separable
  filter (every phase of VTM's 4x4 luma bank has zero outer taps), 12
  multiply-adds or 24 operations.  Bytes: the reference frame read once
  (10-bit samples as 2 bytes), each CU's three CPMVs (int32), and the
  prediction written once (16-bit).
* K2, the block reduction, reads each prediction once with the original
  (read once per launch) and writes per 4x4 block its SATD and, in the 9
  refining evaluates of a mode (5 of 2CP, 4 of 3CP), the five moments
  (int32 each).  Per sample at least: 7 operations of the 4x4 Hadamard
  SATD (16 differences, 64 butterfly adds, 16 absolutes and 15 sums per
  block, rounded down); in a refining launch also 8 of the separable
  Sobel pair and 10 of the five moment products and their sums.  The 2
  other evaluates of a mode (each stage's last) need the SATD alone.

A configuration's ``extra_iters`` (the reference encoder's
``--ExtraGradientIter``) adds that many refining evaluates to each stage,
so two K1 and two K2 launches per mode for each.

A kernel's roofline share is the least time at the peaks over the time
the profiler measured for its launches, so a count kept at the least
work cannot read over 100%.
"""

from __future__ import annotations

import functools

from mebench import geometry

PEAK_BYTES_S = 3.35e12   # HBM3, H100 SXM data sheet
PEAK_OPS_S = 67e12       # FP32 outside the tensor cores, H100 SXM data sheet
ITERS = {2: 5, 3: 4}

K1_OPS_PER_SAMPLE = 24
K2_OPS_SATD = 7
K2_OPS_REFINE = 7 + 8 + 10
CPMV_BYTES = 3 * 2 * 4
BLOCK_SATD_BYTES = 4
BLOCK_MOMENT_BYTES = 5 * 4


@functools.lru_cache(maxsize=None)
def inside(mode: str, fw: int, fh: int):
    """(CUs, samples) of the in-frame CUs of every class of ``mode``."""
    n = s = 0
    for _, _, w, h, _, _, ok in geometry.cus(mode, fw, fh):
        if ok:
            n += 1
            s += w * h
    return n, s


def launches(mode: str, extra_iters: int = 0):
    """(K1, K2 refining, K2 SATD-only) evaluates of one mode per frame-ref,
    with ``extra_iters`` refining iterations added to each stage."""
    refining = ITERS[2] + ITERS[3] + 2 * extra_iters
    return refining + 1, refining, 2


def _least(bytes_, ops):
    tb, to = bytes_ / PEAK_BYTES_S, ops / PEAK_OPS_S
    return max(tb, to), ("bytes" if tb >= to else "ops")


def k1(mode: str, fw: int, fh: int):
    """Least seconds of one K1 evaluate and the bound that binds."""
    n, s = inside(mode, fw, fh)
    return _least(fw * fh * 2 + n * CPMV_BYTES + s * 2, s * K1_OPS_PER_SAMPLE)


def k2(mode: str, fw: int, fh: int, refine: bool):
    """Least seconds of one K2 evaluate and the bound that binds."""
    _, s = inside(mode, fw, fh)
    out = BLOCK_SATD_BYTES + (BLOCK_MOMENT_BYTES if refine else 0)
    ops = K2_OPS_REFINE if refine else K2_OPS_SATD
    return _least(s * 2 + fw * fh * 2 + (s // 16) * out, s * ops)


def frame_ref(fw: int, fh: int, modes=("full", "half"), extra_iters: int = 0):
    """Least seconds of K1 and of K2 over one frame-ref, the launches the
    algorithm makes (the evaluates above, ``extra_iters`` more refining
    ones per stage) and the bounds that bind."""
    t1 = t2 = 0.0
    n1 = n2 = 0
    binds = set()
    for m in modes:
        a, b, c = launches(m, extra_iters)
        s1, w1 = k1(m, fw, fh)
        s2r, w2r = k2(m, fw, fh, True)
        s2s, w2s = k2(m, fw, fh, False)
        t1 += a * s1
        t2 += b * s2r + c * s2s
        n1 += a
        n2 += b + c
        binds |= {f"K1 {w1}", f"K2 {w2r}", f"K2 SATD-only {w2s}"}
    return {"k1_s": t1, "k2_s": t2, "k1_launches": n1, "k2_launches": n2,
            "binds": sorted(binds)}
