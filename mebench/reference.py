"""The plain reference of VTM-12.0's affine motion estimation.

What the benchmark holds the program's decisions against.  It follows the
reference encoder (iagostorch/VVC-Affine-GPU, which mirrors VTM-12.0's
``InterSearch`` affine ME) operation for operation: per CU, numIter+1
rounds of 4x4 sub-block prediction (the 1/16-pel luma filter over an
edge-clamped window), SATD, rate and RD cost, best update, each but the
last followed by the gradient step (per-CU Sobel with border replication,
the normal equations in int64, VTM's float64 Gaussian elimination, the
scaled and clipped CPMV update).  It is plain PyTorch: no kernel, no table
of the program, no graph; CUs of one size are batched, in blocks, so that
a 4K frame fits.  ``solver_dtype`` is for the control only: float32 in
place of the float64 that VTM's ``solveEqual`` uses.

It works out for itself what the program is given or derives: the CU
tables (``geometry``), each POC's reference list and its lambda.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from mebench import geometry

# --- VTM-12.0 constants (reference constants.cl / constants.h) -------------
MV_MIN, MV_MAX = -(1 << 17), (1 << 17) - 1
MAX_LONG = 1 << 62
RUI_BITS = 2                     # low-delay P
MAX_REFS = 4
ITERS = {2: 5, 3: 4}             # numGradientIter per stage
OFF1, SHIFT1 = -8192 << 2, 2     # first (horizontal) filter pass
OFF2, SHIFT2 = (1 << 9) + (8192 << 6), 10
LUMA_FILTER_4x4 = (
    (0, 0, 0, 64, 0, 0, 0, 0), (0, 1, -3, 63, 4, -2, 1, 0),
    (0, 1, -5, 62, 8, -3, 1, 0), (0, 2, -8, 60, 13, -4, 1, 0),
    (0, 3, -10, 58, 17, -5, 1, 0), (0, 3, -11, 52, 26, -8, 2, 0),
    (0, 2, -9, 47, 31, -10, 3, 0), (0, 3, -11, 45, 34, -10, 3, 0),
    (0, 3, -11, 40, 40, -11, 3, 0), (0, 3, -10, 34, 45, -11, 3, 0),
    (0, 3, -10, 31, 47, -9, 2, 0), (0, 2, -8, 26, 52, -11, 3, 0),
    (0, 1, -5, 17, 58, -10, 3, 0), (0, 1, -4, 13, 60, -8, 2, 0),
    (0, 1, -3, 8, 62, -5, 1, 0), (0, 1, -2, 4, 63, -3, 1, 0),
)
# fullLambdas[qp] for the effective QP of a frame (constants.h:94-103)
FULL_LAMBDAS = (
    0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 2.769291, 3.108425, 3.489089, 3.916370, 4.395976, 4.934316,
    5.538583, 6.216849, 6.978177,
    7.832739, 8.791952, 9.868633, 11.077166, 12.433698, 13.956355,
    15.665478, 17.583905, 19.737266, 22.154332,
    24.867397, 27.912709, 31.330957, 35.167810, 39.474532, 44.308664,
    49.734793, 55.825418, 62.661913, 70.335619,
    78.949063, 88.617327, 99.469587, 111.650836, 125.323826, 140.671239,
    157.898127, 177.234655, 198.939174, 223.301672,
    250.647653, 281.342477, 315.796254, 354.469310, 397.878347,
    446.603345, 501.295305, 562.684955, 631.592507, 708.938619,
)
POC_QP_OFFSET = (1, 5, 4, 5, 4, 5, 4, 5)   # GOP-8 low delay
# the result order of one frame-ref: (mode, nCP)
PREDS = (("full", 2), ("full", 3), ("half", 2), ("half", 3))


# --- frame-level choices ---------------------------------------------------

def lambda_for(qp: int, poc: int) -> float:
    """The motion lambda of ``poc``: fullLambdas at the GOP-8 low-delay
    QP of the frame (computeDeltaQp), as a float32 value."""
    scale = 0.0 if poc % 8 == 0 else 0.259
    offset = 0.0 if poc % 8 == 0 else -6.5
    q = qp + POC_QP_OFFSET[poc % 8]
    d = q * scale + offset + 0.5
    return float(np.float32(FULL_LAMBDAS[q + int(math.floor(min(3.0, max(0.0, d))))]))


def reference_lists(n_frames: int) -> Dict[int, List[int]]:
    """POC -> the POCs of its references, in list order, for POCs 1..n.

    VTM's low-delay list of four pictures: each new picture shifts the list
    down by one; once it is full, a slot that holds a long-term picture
    (POC % 8 == 0, with long-term pictures in every slot below it) is
    displaced only by another long-term picture.
    """
    labels, lt = [-1] * 4, [0] * 4
    out = {}
    for poc in range(1, n_frames + 1):
        prev = labels[0]
        labels[0] = poc - 1
        if poc < 5:
            labels[1], labels[2], labels[3] = prev, labels[1], labels[2]
        elif lt[1] == 0 or (prev % 8 == 0 and prev != labels[0]):
            prev, labels[1] = labels[1], prev
            if lt[2] == 0 or (prev % 8 == 0 and prev != labels[1]):
                prev, labels[2] = labels[2], prev
                if lt[3] == 0 or (prev % 8 == 0 and prev != labels[3]):
                    labels[3] = prev
        lt[3] = int(labels[3] % 8 == 0)
        if poc >= 5:
            lt[2] = int(labels[2] % 8 == 0 and lt[3])
            lt[1] = int(labels[1] % 8 == 0 and lt[2])
        out[poc] = labels[:min(MAX_REFS, poc)]
    return out


# --- CU batches --------------------------------------------------------------

class _Group:
    """All CUs of one size in a frame: their result slots and corners."""

    def __init__(self, w, h, rows, device):
        self.w, self.h = w, h
        self.log2w, self.log2h = int(math.log2(w)), int(math.log2(h))
        t = torch.tensor(rows, dtype=torch.int64, device=device)
        self.slot, self.ax, self.ay = t[:, 0], t[:, 1], t[:, 2]
        self.inside = t[:, 3].bool()


@functools.lru_cache(maxsize=16)
def _groups(mode: str, fw: int, fh: int, device: torch.device):
    rows: Dict[Tuple[int, int], list] = {}
    for slot, (_, _, w, h, ax, ay, inside) in enumerate(
            geometry.cus(mode, fw, fh)):
        rows.setdefault((w, h), []).append((slot, ax, ay, int(inside)))
    return tuple(_Group(w, h, r, device) for (w, h), r in rows.items())


def _clip_mv(mvx, mvy, bx, by, fw, fh):
    """clipMv with the CU's corner (aux_functions.cl:37-101)."""
    return (torch.minimum(torch.maximum(mvx, (-128 - 8 - bx + 1) << 4),
                          (fw + 8 - bx - 1) << 4),
            torch.minimum(torch.maximum(mvy, (-128 - 8 - by + 1) << 4),
                          (fh + 8 - by - 1) << 4))


def _round_shift(v, s):
    return (v + (1 << (s - 1)) - (v >= 0).to(v.dtype)) >> s


# --- one evaluate: prediction, SATD, gradients, equations -------------------

def _predict(g, sl, cp, n_cp, ref, fw, fh):
    """Every 4x4 sub-block of the CUs ``sl`` of group ``g`` at CPMVs
    ``cp`` (int64 [b, 3, 2]) -> int64 prediction [b, h, w]."""
    w, h = g.w, g.h
    ax, ay = g.ax[sl], g.ay[sl]
    dev = cp.device
    ltx, lty = cp[:, 0, 0], cp[:, 0, 1]
    hx = (cp[:, 1, 0] - ltx) << (7 - g.log2w)
    hy = (cp[:, 1, 1] - lty) << (7 - g.log2w)
    if n_cp == 3:
        vx = (cp[:, 2, 0] - ltx) << (7 - g.log2h)
        vy = (cp[:, 2, 1] - lty) << (7 - g.log2h)
    else:
        vx, vy = -hy, hx
    # sub-block MVs spread over the limit fall back to the CU centre
    s4 = 4 << 11
    rw = ((4 * hx + s4).abs() >> 11) + 9
    rh = ((4 * hy).abs() >> 11) + 9
    spread = rw * rh > 15 * 11
    rw = ((4 * vx).abs() >> 11) + 9
    rh = ((4 * vy + s4).abs() >> 11) + 9
    spread |= rw * rh > 11 * 15
    sxs = torch.arange(0, w, 4, device=dev)
    sys_ = torch.arange(0, h, 4, device=dev)
    cx = torch.where(spread[:, None, None], w >> 1, (sxs + 2)[None, None, :])
    cy = torch.where(spread[:, None, None], h >> 1, (sys_ + 2)[None, :, None])
    mvx = (ltx << 7)[:, None, None] + hx[:, None, None] * cx + vx[:, None, None] * cy
    mvy = (lty << 7)[:, None, None] + hy[:, None, None] * cx + vy[:, None, None] * cy
    mvx, mvy = _clip_mv(_round_shift(mvx, 7), _round_shift(mvy, 7),
                        ax[:, None, None], ay[:, None, None], fw, fh)
    # 11x11 windows, clamped to the frame
    taps = torch.arange(11, device=dev)
    x0 = ax[:, None, None] + sxs[None, None, :] + (mvx >> 4) - 3
    y0 = ay[:, None, None] + sys_[None, :, None] + (mvy >> 4) - 3
    xs = (x0[..., None] + taps).clamp_(0, fw - 1)
    ys = (y0[..., None] + taps).clamp_(0, fh - 1)
    win = ref[ys[..., :, None] * fw + xs[..., None, :]]   # [b, ny, nx, 11, 11]
    bank = torch.tensor(LUMA_FILTER_4x4, dtype=ref.dtype, device=dev)
    cfx, cfy = bank[mvx & 15], bank[mvy & 15]             # [b, ny, nx, 8]
    tmp = sum(win[..., :, t:t + 4] * cfx[..., None, None, t] for t in range(8))
    tmp = (tmp + OFF1) >> SHIFT1                          # [.., 11, 4]
    out = sum(tmp[..., t:t + 4, :] * cfy[..., None, None, t] for t in range(8))
    out = ((out + OFF2) >> SHIFT2).clamp_(0, 1023)        # [.., 4, 4]
    b, ny, nx = out.shape[:3]
    return out.permute(0, 1, 3, 2, 4).reshape(b, h, w).to(torch.int64)


def _satd(diff):
    """Sum over the 4x4 blocks of the mean-scaled 4x4 Hadamard SATD
    (aux_functions.cl:1940-2043).  diff: int64 [b, h, w] -> [b]."""
    b, h, w = diff.shape
    d = diff.reshape(b, h // 4, 4, w // 4, 4).transpose(2, 3)  # [.., r, c]
    r0, r1, r2, r3 = d.unbind(-2)
    m = (r0 + r3, r1 + r2, r1 - r2, r0 - r3)
    d = torch.stack((m[0] + m[1], m[2] + m[3], m[0] - m[1], m[3] - m[2]), -2)
    c0, c1, c2, c3 = d.unbind(-1)
    m = (c0 + c3, c1 + c2, c1 - c2, c0 - c3)
    d = torch.stack((m[0] + m[1], m[0] - m[1], m[2] + m[3], m[3] - m[2]), -1)
    a = d.abs()
    dc = a[..., 0, 0]
    s = a.sum((-1, -2)) - dc + (dc >> 2)
    return ((s + 1) >> 1).sum((1, 2))


def _equations(pred, err, n_cp):
    """The normal equations of each CU (affine.cl:472-752): per-CU Sobel
    of the prediction with its border replicated, then the int64 sums of
    iC iC^T and of iC * err << 3.  Returns int64 [b, P, P+1]."""
    b, h, w = pred.shape
    p = pred
    gx = (p[:, :-2, 2:] - p[:, :-2, :-2] + 2 * p[:, 1:-1, 2:]
          - 2 * p[:, 1:-1, :-2] + p[:, 2:, 2:] - p[:, 2:, :-2])
    gy = (p[:, 2:, :-2] - p[:, :-2, :-2] + 2 * p[:, 2:, 1:-1]
          - 2 * p[:, :-2, 1:-1] + p[:, 2:, 2:] - p[:, :-2, 2:])
    dev = p.device
    iy = (torch.arange(h, device=dev) - 1).clamp_(0, h - 3)
    ix = (torch.arange(w, device=dev) - 1).clamp_(0, w - 3)
    g1 = gx[:, iy][:, :, ix].reshape(b, -1)
    g2 = gy[:, iy][:, :, ix].reshape(b, -1)
    cx = (((torch.arange(w, device=dev) >> 2) << 2) + 2)[None, :].expand(h, w).reshape(-1)
    cy = (((torch.arange(h, device=dev) >> 2) << 2) + 2)[:, None].expand(h, w).reshape(-1)
    if n_cp == 3:
        ic = [g1, cx * g1, g2, cx * g2, cy * g1, cy * g2]
    else:
        ic = [g1, cx * g1 + cy * g2, g2, cy * g1 - cx * g2]
    P = 2 * n_cp
    e = err.reshape(b, -1)
    A = torch.empty((b, P, P + 1), dtype=torch.int64, device=dev)
    for c in range(P):
        for r in range(c, P):
            A[:, c, r] = A[:, r, c] = (ic[c] * ic[r]).sum(-1)
        A[:, c, P] = (ic[c] * e).sum(-1) << 3
    return A


def _solve(A, n_cp, dtype):
    """VTM's solveEqual: Gaussian elimination with column-maximum
    pivoting in ``dtype`` and its operation order, then back substitution
    (a zero pivot there zeroes the whole solution).  A: int64 [b, P, P+1]
    -> [b, P]."""
    P = 2 * n_cp
    b = A.shape[0]
    a = torch.zeros((b, P + 1, P + 1), dtype=dtype, device=A.device)
    a[:, 1:] = A.to(dtype)
    rows = torch.arange(b, device=A.device)
    for i in range(1, P):
        col = a[:, :, i - 1].abs()
        best = col[:, i]
        idx = torch.full((b,), i, dtype=torch.int64, device=A.device)
        for j in range(i + 1, P + 1):
            better = col[:, j] > best
            best = torch.where(better, col[:, j], best)
            idx = torch.where(better, j, idx)
        row_i, row_p = a[:, i].clone(), a[rows, idx].clone()
        a[:, i] = row_p
        a[rows, idx] = row_i
        for j in range(i + 1, P + 1):
            a[:, j, i:] = a[:, j, i:] - a[:, i, i:] * a[:, j, i - 1:i] / a[:, i, i - 1:i]
    x = torch.zeros((b, P), dtype=dtype, device=A.device)
    x[:, P - 1] = a[:, P, P] / a[:, P, P - 1]
    dead = torch.zeros(b, dtype=torch.bool, device=A.device)
    for i in range(P - 2, -1, -1):
        piv = a[:, i + 1, i]
        dead |= piv == 0
        temp = torch.zeros(b, dtype=dtype, device=A.device)
        for j in range(i + 1, P):
            temp = temp + a[:, i + 1, j] * x[:, j]
        x[:, i] = (a[:, i + 1, P] - temp) / piv
    return torch.where(dead[:, None], 0, x)


def _deltas(x, n_cp, w, h):
    """scaleDeltaMvs: the solution as six CPMV deltas at 1/16 pel, int32
    [b, 3, 2] (LT, RT, LB).  The reference's deltas and CPMVs are 32-bit
    ``int``: the conversion saturates (as the GPU's does), and the shift
    to 1/16 pel and the addition to the CPMV wrap.  A near-singular system
    reaches that (parameters of 1e16 occur at 4K)."""
    z = torch.zeros_like(x[:, 0])
    if n_cp == 3:
        d = [x[:, 0], x[:, 1] * w + x[:, 0], x[:, 2], x[:, 3] * w + x[:, 2],
             x[:, 4] * h + x[:, 0], x[:, 5] * h + x[:, 2]]
    else:
        d = [x[:, 0], x[:, 1] * w + x[:, 0], x[:, 2], -x[:, 3] * w + x[:, 2],
             z, z]
    d = torch.stack(d, -1)
    v = d * 4 + torch.where(d >= 0, 0.5, -0.5)
    iv = torch.where(torch.isnan(v), 0,
                     torch.trunc(v.clamp(-2.0 ** 31, 2.0 ** 31 - 1)))
    iv = iv.to(torch.int32) << 2
    return torch.stack([iv[:, [0, 2]], iv[:, [1, 3]], iv[:, [4, 5]]], 1)


def _bits(cp, n_cp):
    """xCalcAffineMVBits against a zero predictor, plus the mode's base
    bits, at quarter-pel AMVR precision."""
    q = torch.where(cp >= 0, (cp + 1) >> 2, (cp + 2) >> 2)
    vals = [q[:, 0, 0], q[:, 0, 1], q[:, 1, 0] - q[:, 0, 0], q[:, 1, 1] - q[:, 0, 1]]
    if n_cp == 3:
        vals += [q[:, 2, 0] - q[:, 0, 0], q[:, 2, 1] - q[:, 0, 1]]
    v = torch.stack(vals, -1)
    t = torch.where(v <= 0, ((-v) << 1) + 1, v << 1)
    length = torch.ones_like(t)
    for _ in range(4):          # |v| < 2^18: t > 128 at most three times
        big = t > 128
        length = length + 14 * big
        t = torch.where(big, t >> 7, t)
    log2 = sum((t >= (1 << k)).to(t.dtype) for k in range(1, 8))
    return (length + 2 * log2).sum(-1) + RUI_BITS


def _lb_from_2cp(cp, g, fw, fh):
    """The 3CP stage's starting LB from the 2CP result (affine.cl:83-105)."""
    s = 7 + g.log2h - g.log2w
    ltx, lty, rtx, rty = cp[:, 0, 0], cp[:, 0, 1], cp[:, 1, 0], cp[:, 1, 1]
    vx = _round_shift((ltx << 7) - ((rty - lty) << s), 7).clamp(-(1 << 17), (1 << 17) - 1)
    vy = _round_shift((lty << 7) + ((rtx - ltx) << s), 7).clamp(-(1 << 17), (1 << 17) - 1)
    q = lambda v: torch.where(v >= 0, (v + 1) >> 2, (v + 2) >> 2) << 2
    return torch.stack(_clip_mv(q(vx), q(vy), g.ax, g.ay, fw, fh), -1)


def _stage_group(g, n_cp, ref, orig, fw, fh, lam, init, solver_dtype,
                 block_sbs, extra_iters):
    """The whole search of one stage for the CUs of group ``g``, with
    ``extra_iters`` gradient iterations beyond VTM's."""
    B = g.slot.numel()
    P = 2 * n_cp
    per = max(1, block_sbs // ((g.w // 4) * (g.h // 4)))
    dev = ref.device
    yy = torch.arange(g.h, device=dev)[:, None]
    xx = torch.arange(g.w, device=dev)[None, :]
    curr = init
    best_cost = torch.full((B,), MAX_LONG, dtype=torch.int64, device=dev)
    best_cp = torch.zeros_like(curr)
    lam32 = torch.tensor(lam, dtype=torch.float32, device=dev)
    n_iters = ITERS[n_cp] + extra_iters
    for it in range(n_iters + 1):
        refine = it < n_iters
        satd = torch.zeros(B, dtype=torch.int64, device=dev)
        A = torch.zeros((B, P, P + 1), dtype=torch.int64, device=dev)
        for lo in range(0, B, per):
            sl = slice(lo, min(B, lo + per))
            pred = _predict(g, sl, curr[sl], n_cp, ref, fw, fh)
            oy = (g.ay[sl, None, None] + yy).clamp(max=fh - 1)
            ox = (g.ax[sl, None, None] + xx).clamp(max=fw - 1)
            err = orig[oy * fw + ox] - pred
            satd[sl] = _satd(err)
            if refine:
                A[sl] = _equations(pred, err, n_cp)
        inside = g.inside
        satd = torch.where(inside, satd, 0)
        cost = satd + torch.floor(lam32 * _bits(curr, n_cp).to(torch.float32)).to(torch.int64)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_cp = torch.where(better[:, None, None], curr, best_cp)
        if not refine:
            break
        A = torch.where(inside[:, None, None], A, 0)
        new = (curr.to(torch.int32)
               + _deltas(_solve(A, n_cp, solver_dtype), n_cp, g.w, g.h)
               ).to(torch.int64).clamp(MV_MIN, MV_MAX)
        curr = torch.stack(_clip_mv(new[..., 0], new[..., 1], g.ax[:, None],
                                    g.ay[:, None], fw, fh), -1)
    return best_cost, best_cp


def stage(mode, n_cp, ref, orig, fw, fh, lam, prev=None,
          solver_dtype=torch.float64, block_sbs=1 << 17, extra_iters=0):
    """One stage over a frame: ``ref``/``orig`` int32 [fh*fw] on any
    device, ``prev`` the 2CP result's CPMVs for a 3CP stage,
    ``extra_iters`` the iterations added to VTM's (the reference encoder's
    ``--ExtraGradientIter``).  Returns
    (costs int64 [nCtu, nCU], cpmvs int32 [nCtu, nCU, 3, 2]) in result
    order."""
    dev = ref.device
    n_ctu = math.prod(geometry.ctu_grid(fw, fh))
    n_cu = geometry.cus_per_ctu(mode)
    costs = torch.empty(n_ctu * n_cu, dtype=torch.int64, device=dev)
    cps = torch.empty((n_ctu * n_cu, 3, 2), dtype=torch.int64, device=dev)
    flat_prev = None if prev is None else prev.reshape(-1, 3, 2).to(dev, torch.int64)
    for g in _groups(mode, fw, fh, dev):
        if n_cp == 2:
            init = torch.zeros((g.slot.numel(), 3, 2), dtype=torch.int64, device=dev)
        else:
            p = flat_prev[g.slot]
            init = torch.cat([p[:, :2], _lb_from_2cp(p, g, fw, fh)[:, None]], 1)
        c, cp = _stage_group(g, n_cp, ref, orig, fw, fh, lam, init,
                             solver_dtype, block_sbs, extra_iters)
        costs[g.slot] = c
        cps[g.slot] = cp
    return costs.reshape(n_ctu, n_cu), cps.to(torch.int32).reshape(n_ctu, n_cu, 3, 2)


def frame_ref(ref, orig, fw, fh, lam, solver_dtype=torch.float64,
              modes=("full", "half"), extra_iters=0):
    """The four decisions of one (frame, reference): for each mode its 2CP
    stage and the 3CP stage fed from it, each with ``extra_iters``
    iterations beyond VTM's.  Returns {(mode, nCP): (costs, cpmvs)}."""
    out = {}
    for mode in modes:
        out[(mode, 2)] = stage(mode, 2, ref, orig, fw, fh, lam,
                               solver_dtype=solver_dtype,
                               extra_iters=extra_iters)
        out[(mode, 3)] = stage(mode, 3, ref, orig, fw, fh, lam,
                               prev=out[(mode, 2)][1], solver_dtype=solver_dtype,
                               extra_iters=extra_iters)
    return out
