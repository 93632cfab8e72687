"""Per-block SATD and normal-equation moments of prediction planes (kernel K2).

For each (CTU, bin) prediction plane and the CTU's original plane:

* the SATD of every 4x4 block of ``orig - pred`` (VTM 4x4 Hadamard with the
  JVET_R0164 mean scaling, aux_functions.cl:1940-2043);
* with ``refine``, the Sobel gradients of ``pred`` with the reference's
  per-CU border replication (affine.cl:472-540) and the per-block sums of
  gx*gx, gx*gy, gy*gy, gx*err, gy*err — the five moments the normal
  equations are assembled from (affine.cl:680-694).

Both outputs are in block form: satd int32 [nCtu, nBins, NB, NB] and
moments int32 [nCtu, nBins, 5, NB, NB] (exact in int32: per-sample products
< 2^25, 16-sample sums < 2^29; the engine widens them to int64 per CU).

* ``reduce_blocks_plain``: the plain PyTorch version — the JAX engine's
  unfused reduction (``_blocks16`` sample-major blocks, ``satd_4x4``,
  ``_sobel_replicated``, the moment products; ``affine_plane.py:376-428,
  886-960`` of the JAX package).
* ``reduce_blocks``: the wrapper the engine calls.  On CUDA tensors it
  launches the hand-written kernel ``csrc/blockreduce.cu``; on CPU tensors
  it runs the plain version.
* ``replication_flags``: the border replication of each bin reduced to four
  flags per 4x4 block (the kernel's form of the masks), derived once per
  PlaneTables; ``replicate_blocks`` applies them to raw gradients (their
  plain mirror, which the tests hold against ``_sobel_replicated``).

Outputs are defined everywhere, but the engine reads only the valid slots
of in-frame CUs (every consumer masks at CU level).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.ops.satd import satd_4x4

NB = 32

# packed border-mask bits (affine_plane.build_tables)
TOP, BOT, LEFT, RIGHT = 1, 2, 4, 8


def _blocks16(x):
    """[..., 128, 128] -> [..., 16, NB*NB] 4x4 blocks, sample-major.

    Entry [..., 4r+c, by*NB+bx] = sample (r, c) of block (by, bx).
    """
    s = x.reshape(x.shape[:-2] + (NB, 4, NB, 4))
    s = s.movedim((-3, -1), (-4, -3))                 # [..., 4, 4, NB, NB]
    return s.reshape(x.shape[:-2] + (16, NB * NB))


def _sobel_replicated(plane, row_top, row_bot, col_left, col_right):
    """Full-plane Sobel with per-CU border replication (affine.cl:472-540).

    plane: int32 [..., 128, 128]; masks: bool broadcastable to it.  Zero
    padding outside the plane.  Replication runs rows first (TOP beats BOT),
    then columns on the row-replicated gradients (LEFT beats RIGHT).
    """
    pp = F.pad(plane, (1, 1, 1, 1))
    gx = (
        pp[..., :-2, 2:] - pp[..., :-2, :-2]
        + 2 * pp[..., 1:-1, 2:] - 2 * pp[..., 1:-1, :-2]
        + pp[..., 2:, 2:] - pp[..., 2:, :-2]
    )
    gy = (
        pp[..., 2:, :-2] - pp[..., :-2, :-2]
        + 2 * pp[..., 2:, 1:-1] - 2 * pp[..., :-2, 1:-1]
        + pp[..., 2:, 2:] - pp[..., :-2, 2:]
    )

    def repl(g):
        down = torch.cat([g[..., 1:, :], g[..., -1:, :]], dim=-2)
        up = torch.cat([g[..., :1, :], g[..., :-1, :]], dim=-2)
        g = torch.where(row_top, down, torch.where(row_bot, up, g))
        rightv = torch.cat([g[..., :, 1:], g[..., :, -1:]], dim=-1)
        leftv = torch.cat([g[..., :, :1], g[..., :, :-1]], dim=-1)
        return torch.where(col_left, rightv, torch.where(col_right, leftv, g))

    return repl(gx), repl(gy)


def replication_flags(border_packed):
    """Per-block replication flags uint8 [nBins, NB, NB] from the masks.

    The per-sample rule of ``_sobel_replicated``: a sample's gradient comes
    from column x+1 (LEFT) or x-1 (RIGHT), then from row y+1 (TOP) or y-1
    (BOT) by the mask at that column, clamped to the plane.  When every CU
    is on the 4-sample grid and at least 4 wide and high (both layouts),
    the sources stay inside the sample's 4x4 block and the rule reduces to
    TOP (row 0 from row 1), BOT (row 3 from row 2), LEFT (column 0 from
    column 1) and RIGHT (column 3 from column 2) per block.  Raises
    ValueError for masks that do not reduce so.
    """
    m = border_packed.to(torch.int32)
    n = m.shape[0]
    i = torch.arange(128, dtype=torch.int64, device=m.device)
    xs = torch.where((m & LEFT) != 0, (i + 1).clamp(max=127),
                     torch.where((m & RIGHT) != 0, (i - 1).clamp(min=0), i))
    m2 = torch.gather(m, 2, xs)
    iy = i[:, None]
    ys = torch.where((m2 & TOP) != 0, (iy + 1).clamp(max=127),
                     torch.where((m2 & BOT) != 0, (iy - 1).clamp(min=0), iy))
    dy = (ys - iy).reshape(n, NB, 4, NB, 4)
    dx = (xs - i).reshape(n, NB, 4, NB, 4)
    top, bot = dy[:, :, 0, :, 0] == 1, dy[:, :, 3, :, 0] == -1
    left, right = dx[:, :, 0, :, 0] == 1, dx[:, :, 0, :, 3] == -1
    zero = torch.zeros_like(top, dtype=torch.int64)
    want_dy = torch.stack([top.long(), zero, zero, -bot.long()], dim=2)
    want_dx = torch.stack([left.long(), zero, zero, -right.long()], dim=3)
    if not (torch.equal(dy, want_dy[..., None].expand_as(dy))
            and torch.equal(dx, want_dx[:, :, None].expand_as(dx))):
        raise ValueError("border masks do not reduce to per-4x4-block "
                         "replication flags")
    flags = (top * TOP) | (bot * BOT) | (left * LEFT) | (right * RIGHT)
    return flags.to(torch.uint8)


def replicate_blocks(g, flags):
    """Apply per-block replication flags to raw gradients.

    g: int32 [..., nBins, 128, 128]; flags: uint8 [nBins, NB, NB].  Rows
    first (row 0 from row 1 under TOP, row 3 from row 2 under BOT), then
    columns (column 0 from column 1 under LEFT, column 3 from 2 under
    RIGHT): what the kernel does in registers.
    """
    f = flags.to(torch.int32)
    b = g.reshape(g.shape[:-2] + (NB, 4, NB, 4)).clone()

    def bit(v):
        return ((f & v) != 0)[:, :, None, :]             # [nBins, NB, 1, NB]

    b[..., 0, :, :] = torch.where(bit(TOP)[..., 0, :, None],
                                  b[..., 1, :, :], b[..., 0, :, :])
    b[..., 3, :, :] = torch.where(bit(BOT)[..., 0, :, None],
                                  b[..., 2, :, :], b[..., 3, :, :])
    b[..., 0] = torch.where(bit(LEFT), b[..., 1], b[..., 0])
    b[..., 3] = torch.where(bit(RIGHT), b[..., 2], b[..., 3])
    return b.reshape(g.shape)


def reduce_blocks_plain(pred, orig, border_packed, refine: bool):
    """Plain PyTorch version of K2 (same contract as ``reduce_blocks``)."""
    n_ctu = pred.shape[0]
    n_bins = border_packed.shape[0]
    pred32 = pred.to(torch.int32).expand(n_ctu, n_bins, 128, 128)
    orig16 = _blocks16(orig.to(torch.int32))[:, None]      # [nCtu, 1, 16, NB²]
    pred16 = _blocks16(pred32)                              # [nCtu, nB, 16, NB²]
    satd = satd_4x4(orig16, pred16, sample_axis=-2).reshape(
        n_ctu, n_bins, NB, NB)
    if not refine:
        return satd, None
    masks = [(border_packed & bit) != 0 for bit in (TOP, BOT, LEFT, RIGHT)]
    gx, gy = _sobel_replicated(pred32, *masks)
    gx16, gy16 = _blocks16(gx), _blocks16(gy)
    err16 = orig16 - pred16
    prods = torch.stack([gx16 * gx16, gx16 * gy16, gy16 * gy16,
                         gx16 * err16, gy16 * err16], dim=2)
    moments = prods.sum(dim=-2, dtype=torch.int32).reshape(
        n_ctu, n_bins, 5, NB, NB)
    return satd, moments


def reduce_blocks(pred, orig, border_packed, refine: bool, repl):
    """SATD (+ moments) of every (CTU, bin) plane, in block form.

    pred: int16 [nCtu, nBins | 1, 128, 128] (a length-1 bin axis broadcasts
    — the zero-motion iteration); orig: int32 [nCtu, 128, 128];
    border_packed: int32 [nBins, 128, 128] per-bin CU border masks
    (TOP|BOT|LEFT|RIGHT bits), which the plain version reads; repl: their
    ``replication_flags``, which the kernel reads (the engine passes the
    PlaneTables' copies of both).  Returns satd int32 [nCtu, nBins, NB, NB]
    and, when ``refine``, moments int32 [nCtu, nBins, 5, NB, NB] (else
    None).
    """
    if pred.device.type == "cpu":
        return reduce_blocks_plain(pred, orig, border_packed, refine)
    satd, moments, run = bind_reduce_blocks(pred, orig, repl, refine)
    run()
    return satd, moments


def bind_reduce_blocks(pred, orig, repl, refine: bool):
    """K2 bound to CUDA inputs (``reduce_blocks``' contract, the masks
    given as their replication flags ``repl``): returns the output tensors
    and a callable that launches the kernel into them."""
    n_ctu, pred_bins = pred.shape[:2]
    n_bins = repl.shape[0]
    if pred_bins not in (1, n_bins):
        raise ValueError(f"pred has {pred_bins} bins, repl {n_bins}")
    dev = pred.device
    kernels.check(pred, torch.int16, (n_ctu, pred_bins, 128, 128), "pred")
    kernels.check(orig, torch.int32, (n_ctu, 128, 128), "orig", dev)
    kernels.check(repl, torch.uint8, (n_bins, NB, NB), "repl", dev)
    kernels.check_aligned(pred, "pred")
    kernels.check_aligned(orig, "orig")
    satd = torch.empty((n_ctu, n_bins, NB, NB), dtype=torch.int32, device=dev)
    moments = (torch.empty((n_ctu, n_bins, 5, NB, NB), dtype=torch.int32,
                           device=dev) if refine else None)
    return satd, moments, kernels.bind("blockreduce", dev, satd, moments,
                                       pred, orig, repl, n_ctu, n_bins,
                                       pred_bins)
