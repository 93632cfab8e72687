"""Dense Affine-ME engine operating on per-class CTU planes, in PyTorch.

Port of the JAX package's ``models/affine_plane.py``.  Same stage contract —
for every CU of every canonical size class, numGradientIter+1 rounds of
prediction -> SATD -> RD cost -> best update interleaved with gradient
refinement (the affine_gradient_mult_sizes(_HA) kernels,
affine.cl:11-958/960-1950):

* Every class is evaluated as a full 128x128 CTU plane; disjoint
  half-aligned classes share planes ("bins", ``planes.bin_layout``).
  Per-block motion (integer displacement dy/dx) and filter phases (fx/fy)
  are DATA planes.
* Each evaluate runs four kernels: the motion planes (``_mv_planes``)
  turn the CUs' CPMVs into those per-block planes, the warp K1
  (``ops.warp.warp``) predicts every bin plane, the block reduction K2
  (``ops.blockreduce.reduce_blocks``) turns each plane into per-block SATD
  and normal-equation moments, and the CU fold (``_fold_cu``) sums those
  into each CU's SATD and normal equations.  On CUDA tensors all four are
  hand-written kernels (the motion planes: ``ops.mvplanes``, one launch
  reading the static per-block table ``PlaneTables.mv_slots``; the CU
  fold: ``ops.cufold``, one launch reading that table and the lane table
  ``PlaneTables.fold_lanes``); on CPU tensors their plain PyTorch versions
  run (the motion planes' and the CU fold's are loops over the CU
  classes, ``_mv_planes_plain`` and ``_fold_cu_plain``).  Because the warp
  computes each window's address from (dy, dx) with clamping, it is exact
  for any displacement: none of the JAX engine's TPU dispatch machinery
  (R-ladder, rebased windows, escape fix-up) exists here.
* Per-CU quantities (SATD sums, equation systems, CPMV updates) move
  between CU tensors (canonical class order — the reference's return-array
  contract) and slot planes through static slices and index tables built
  once on the device (``planes``): a stage indexes with no host data, so
  that on a card it can run as one captured CUDA graph (``build_stage``,
  ``build_pair_stage``; ``runtime.graphs``), the counterpart of the JAX
  package's jitted stage.

Integer arithmetic stays int32 where the JAX engine keeps int32 and widens to
int64 per CU where it widens; the solver runs eagerly in float64; the RD cost
multiplies a float32 lambda.  Outputs are bit-identical to the JAX engine.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import geometry as G
from vvc_affine_tpu_torch import planes as P
from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.ops import blockreduce as blockreduce_ops
from vvc_affine_tpu_torch.ops import cost as cost_ops
from vvc_affine_tpu_torch.ops import cufold as cufold_ops
from vvc_affine_tpu_torch.ops import mv as mv_ops
from vvc_affine_tpu_torch.ops import mvplanes as mvplanes_ops
from vvc_affine_tpu_torch.ops import solver as solver_ops
from vvc_affine_tpu_torch.ops import warp as warp_ops
from vvc_affine_tpu_torch.runtime import graphs
from vvc_affine_tpu_torch.runtime.frames import check_samples
from vvc_affine_tpu_torch.utils.bitmath import clamp

NB = P.NB


@dataclass(frozen=True)
class PlaneSpec:
    mode: str          # 'full' | 'half'
    n_cp: int          # 2 | 3
    frame_w: int
    frame_h: int
    extra_iters: int = 0

    @property
    def num_gradient_iters(self) -> int:
        return (5 if self.n_cp == 2 else 4) + self.extra_iters


class ClassTensors(NamedTuple):
    """Static per-class slot planes of one canonical class, on the device."""

    slot_valid: torch.Tensor     # bool  [NB, NB]
    slot_cx: torch.Tensor        # int32 [NB, NB]
    slot_cy: torch.Tensor        # int32 [NB, NB]
    # n_cp -> (coefficient planes of the unique M terms p <= q, int64
    # [3, T, NB, NB] for the (gx², gx·gy, gy²) moments; of the rhs terms,
    # int64 [2, 2*n_cp, NB, NB] for the (gx·e, gy·e) moments)
    eq: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    # per sub-grid, its CU ids on the device or None (planes.subgrid_index)
    cu_index: Tuple[Optional[torch.Tensor], ...]
    # n_cp -> int64 [P*P]: the unique term (``_term_order``) of each entry
    # of the symmetric P x P system, row-major; shared by every class
    sym: Dict[int, torch.Tensor]


class PlaneTables(NamedTuple):
    n_ctu_y: int
    n_ctu_x: int
    n_ctus: int
    n_cus: int
    n_cls: int
    n_bins: int
    bins: Tuple[Tuple[int, ...], ...]  # disjoint-class packing (planes.bin_layout)
    bin_of: np.ndarray                 # int32 [n_cls] (host: loop structure)
    border_packed: torch.Tensor        # int32 [n_bins, 128, 128] bit-packed
    repl: torch.Tensor                 # uint8 [n_bins, NB, NB] K2 block flags
    mv_slots: torch.Tensor             # int32 [6, n_bins, NB, NB] block table
    fold_lanes: torch.Tensor           # int32 [7, n_lanes] CU fold's lanes
    slab_active: torch.Tensor          # int32 [nCtus, n_bins, 16]
    strides: Tuple[int, ...]           # canonical per-class CU offsets
    cls: Tuple[P.ClassPlane, ...]
    # canonical per-CU tables [nCtu, nCU] / [nCU]
    abs_x: torch.Tensor
    abs_y: torch.Tensor
    within: torch.Tensor               # bool
    cu_w: torch.Tensor
    cu_h: torch.Tensor
    ctu_x: torch.Tensor                # [nCtu]
    ctu_y: torch.Tensor
    cls_t: Tuple[ClassTensors, ...]    # per-class slot planes on the device


# PlaneTables fields that are tensors (built from numpy arrays)
_TENSOR_FIELDS = ("border_packed", "repl", "mv_slots", "fold_lanes",
                  "slab_active", "abs_x", "abs_y", "within", "cu_w", "cu_h",
                  "ctu_x", "ctu_y")
# PlaneTables fields that lead with the CTU axis (``ctu_rows``)
_CTU_FIELDS = ("slab_active", "abs_x", "abs_y", "within", "ctu_x", "ctu_y")


def slab_activity(mode: str, within: np.ndarray) -> np.ndarray:
    """Per-CTU slab activity int32 [nCtu, n_bins, 16] from the in-frame mask.

    Slab k of a bin is active iff some within-frame CU of a class in the
    bin covers block row 2k or 2k+1.  The warp skips inactive slabs, whose
    outputs are then unspecified: every consumer masks at CU level, and
    Sobel never reads them because no within-CU interior intersects an
    inactive slab and CU border rows are replication-masked.
    """
    lay = G.layout(mode)
    cls = P.plane_layout(mode)
    bins, bin_of = P.bin_layout(mode)
    n_ctu = within.shape[0]
    act = np.zeros((n_ctu, len(bins), 16), bool)
    for ci, cp_tab in enumerate(cls):
        c = lay.classes[ci]
        s = lay.return_strides[ci]
        w_cu = within[:, s:s + cp_tab.num_cus]          # [nCtu, num_cus]
        rowcover = np.zeros((n_ctu, NB), bool)
        for j, y0 in enumerate(c.ys):
            b0y, sh = y0 // 4, c.height // 4
            rowcover[:, b0y:b0y + sh] |= w_cu[:, j:j + 1]
        act[:, int(bin_of[ci])] |= rowcover.reshape(n_ctu, 16, 2).any(-1)
    return act.astype(np.int32)


def host_replication_flags(border_packed: np.ndarray) -> np.ndarray:
    """K2's replication flags uint8 [n_bins, NB, NB] of the host masks
    (``ops.blockreduce.replication_flags`` run on the CPU): a table of the
    layout, built before anything moves to the card."""
    return blockreduce_ops.replication_flags(
        torch.from_numpy(np.asarray(border_packed, np.int32))).numpy()


def _tables_numpy(spec: PlaneSpec, n_ctu_pad: int = 0) -> dict:
    """The JAX engine's PlaneTables fields (numpy) for this geometry.

    With ``n_ctu_pad`` the CTU axis is padded to that many entries, as the
    JAX package's ``parallel/mesh._padded_dyn_tables`` pads it: padding
    CTUs sit at (frame_w, frame_h), so every CU in them fails the in-frame
    test and their slabs are inactive (K1 skips them).  ``n_ctu_y`` and
    ``n_ctu_x`` stay the frame's grid.
    """
    lay = G.layout(spec.mode)
    grid = G.frame_grid(spec.frame_w, spec.frame_h)
    ctu_x, ctu_y = grid.ctu_origin()
    if n_ctu_pad > grid.num_ctus:
        extra = n_ctu_pad - grid.num_ctus
        ctu_x = np.concatenate([ctu_x, np.full(extra, spec.frame_w, np.int32)])
        ctu_y = np.concatenate([ctu_y, np.full(extra, spec.frame_h, np.int32)])
    abs_x = ctu_x[:, None] + lay.cu_x[None, :]
    abs_y = ctu_y[:, None] + lay.cu_y[None, :]
    within = (abs_x + lay.cu_w[None, :] <= spec.frame_w) & (
        abs_y + lay.cu_h[None, :] <= spec.frame_h)
    cls = P.plane_layout(spec.mode)
    bins, bin_of = P.bin_layout(spec.mode)
    # 2-D border masks: with mixed classes in one bin, another class's
    # border row/col can pass through this class's CU interior in other
    # columns/rows, so 1-D masks would misreplicate
    border = np.zeros((len(bins), 128, 128), np.int32)
    for bi, ids in enumerate(bins):
        for ci in ids:
            c = lay.classes[ci]
            for x0, y0 in zip(c.xs, c.ys):
                border[bi, y0, x0:x0 + c.width] |= blockreduce_ops.TOP
                border[bi, y0 + c.height - 1, x0:x0 + c.width] |= \
                    blockreduce_ops.BOT
                border[bi, y0:y0 + c.height, x0] |= blockreduce_ops.LEFT
                border[bi, y0:y0 + c.height, x0 + c.width - 1] |= \
                    blockreduce_ops.RIGHT
    return dict(
        n_ctu_y=grid.ctu_rows, n_ctu_x=grid.ctu_cols, n_ctus=len(ctu_x),
        n_cus=lay.cus_per_ctu, n_cls=len(lay.classes),
        n_bins=len(bins), bins=bins, bin_of=bin_of,
        border_packed=border, repl=host_replication_flags(border),
        mv_slots=P.bin_slot_table(spec.mode),
        fold_lanes=P.fold_lane_table(spec.mode),
        slab_active=slab_activity(spec.mode, within),
        strides=lay.return_strides, cls=cls,
        abs_x=abs_x.astype(np.int32), abs_y=abs_y.astype(np.int32),
        within=within, cu_w=lay.cu_w.astype(np.int32),
        cu_h=lay.cu_h.astype(np.int32),
        ctu_x=ctu_x.astype(np.int32), ctu_y=ctu_y.astype(np.int32),
    )


def _factor_planes(cp_tab: P.ClassPlane, n_cp: int):
    """Static per-slot equation factors (equations.py linear-form model)."""
    cx = cp_tab.slot_cx.astype(np.int64)
    cy = cp_tab.slot_cy.astype(np.int64)
    one = np.ones_like(cx)
    zero = np.zeros_like(cx)
    if n_cp == 3:
        a = [one, cx, zero, zero, cy, zero]
        b = [zero, zero, one, cx, zero, cy]
    else:
        a = [one, cx, zero, cy]
        b = [zero, cy, one, -cx]
    return a, b


def _term_order(n_cp: int):
    """The unique (p, q), p <= q, entries of the symmetric system."""
    Pn = 2 * n_cp
    return [(p, q) for p in range(Pn) for q in range(p, Pn)]


def _sym_index(n_cp: int):
    """Row-major positions in ``_term_order`` of the entries of the
    symmetric system (entry (p, q) and (q, p) share one term)."""
    cell = {}
    for k, (p, q) in enumerate(_term_order(n_cp)):
        cell[(p, q)] = cell[(q, p)] = k
    Pn = 2 * n_cp
    return [cell[(p, q)] for p in range(Pn) for q in range(Pn)]


def _class_tensors(cp_tab: P.ClassPlane, device, sym) -> ClassTensors:
    eq = {}
    for n_cp in (2, 3):
        a, b = _factor_planes(cp_tab, n_cp)
        order = _term_order(n_cp)
        coef_m = np.stack([
            np.stack([a[p] * a[q] for p, q in order]),
            np.stack([a[p] * b[q] + a[q] * b[p] for p, q in order]),
            np.stack([b[p] * b[q] for p, q in order])])
        coef_r = np.stack([np.stack(a), np.stack(b)])
        eq[n_cp] = (torch.as_tensor(coef_m, device=device),
                    torch.as_tensor(coef_r, device=device))
    return ClassTensors(
        slot_valid=torch.as_tensor(cp_tab.slot_valid, device=device),
        slot_cx=torch.as_tensor(cp_tab.slot_cx, device=device),
        slot_cy=torch.as_tensor(cp_tab.slot_cy, device=device),
        eq=eq, cu_index=P.subgrid_index(cp_tab, device), sym=sym)


def tables_from_numpy(d: dict, device) -> PlaneTables:
    """Rebuild PlaneTables on ``device`` from the JAX PlaneTables fields.

    ``d`` maps field names to ints, tuples and numpy arrays (the JAX
    engine's ``PlaneTables._asdict()`` or ``_tables_numpy``); fields the
    port does not use are ignored.  The class geometry (``cls``) is the
    port's own for the mode that ``n_cls`` implies.  K2's replication flags
    (``repl``), the motion-plane kernel's block table (``mv_slots``) and the
    CU fold's lanes (``fold_lanes``) are host tables like the rest: taken
    from ``d``, or for the JAX tables, which have none of them, derived on
    the host (``host_replication_flags`` of their masks;
    ``planes.bin_slot_table`` and ``planes.fold_lane_table`` of the mode).
    """
    mode = {12: "full", 24: "half"}[int(d["n_cls"])]
    cls = P.plane_layout(mode)
    if "repl" not in d:
        d = {**d, "repl": host_replication_flags(d["border_packed"])}
    if "mv_slots" not in d:
        d = {**d, "mv_slots": P.bin_slot_table(mode)}
    if "fold_lanes" not in d:
        d = {**d, "fold_lanes": P.fold_lane_table(mode)}
    kw = {k: d[k] for k in PlaneTables._fields
          if k not in _TENSOR_FIELDS + ("cls", "cls_t", "bin_of")}
    kw.update({k: torch.as_tensor(np.asarray(d[k]), device=device)
               for k in _TENSOR_FIELDS})
    kw["bin_of"] = np.asarray(d["bin_of"], np.int32)
    kw["bins"] = tuple(tuple(int(c) for c in b) for b in d["bins"])
    kw["strides"] = tuple(int(s) for s in d["strides"])
    sym = {n_cp: torch.tensor(_sym_index(n_cp), dtype=torch.int64,
                              device=device) for n_cp in (2, 3)}
    return PlaneTables(
        cls=cls, cls_t=tuple(_class_tensors(c, device, sym) for c in cls),
        **kw)


def build_tables(spec: PlaneSpec, device=None,
                 n_ctu_pad: int = 0) -> PlaneTables:
    """Tables on ``device`` (``cuda`` unless given), the CTU axis
    optionally padded to ``n_ctu_pad`` entries (``_tables_numpy``)."""
    return tables_from_numpy(_tables_numpy(spec, n_ctu_pad),
                             resolve_device(device))


def ctu_rows(t: PlaneTables, lo: int, hi: int) -> PlaneTables:
    """CTUs [lo, hi) of ``t``: views of the per-CTU fields, the static
    fields shared."""
    return t._replace(n_ctus=hi - lo,
                      **{f: getattr(t, f)[lo:hi] for f in _CTU_FIELDS})


def _class_slice(t: PlaneTables, ci: int):
    s = t.strides[ci]
    return slice(s, s + t.cls[ci].num_cus)


def _mv_planes(spec: PlaneSpec, t: PlaneTables, cpmvs):
    """Per-bin displacement/phase planes from canonical CPMVs.

    Returns dy, dx, fx, fy int32 [nCtu, nBins, NB, NB].  Out-of-frame CUs
    are forced to zero motion (their results are masked out downstream,
    matching the reference's skipped-pass semantics, affine.cl:192-208),
    and so are blocks no class of the bin covers.  CUDA CPMVs launch the
    hand-written kernel once (``ops.mvplanes``, on ``t.mv_slots``); CPU
    CPMVs run the plain version, ``_mv_planes_plain``.
    """
    if cpmvs.device.type == "cpu":
        return _mv_planes_plain(spec, t, cpmvs)
    return mvplanes_ops.mv_planes(cpmvs, t.abs_x, t.abs_y, t.within,
                                  t.mv_slots, spec.n_cp, spec.frame_w,
                                  spec.frame_h)


def _mv_planes_plain(spec: PlaneSpec, t: PlaneTables, cpmvs):
    """The plain version of ``_mv_planes`` (the JAX engine's): per CU
    class, its CUs' deltas, spread flags and bases spread onto the slot
    planes, the MVs at the slot centres rounded and clipped, and the
    classes of a bin summed."""
    acc = [[None] * t.n_bins for _ in range(4)]
    for ci, cp_tab in enumerate(t.cls):
        ct = t.cls_t[ci]
        sl = _class_slice(t, ci)
        cp = cpmvs[:, sl]
        log2w = int(np.log2(cp_tab.width))
        log2h = int(np.log2(cp_tab.height))
        hx, hy, vx, vy = mv_ops.affine_deltas(cp, log2w, log2h, spec.n_cp)
        spread = mv_ops.is_spread_over_limit(hx, hy, vx, vy)
        base_x = cp[..., 0, 0] << (C.MAX_CU_DEPTH - 4 + 4)
        base_y = cp[..., 0, 1] << (C.MAX_CU_DEPTH - 4 + 4)
        w_cu = t.within[:, sl]
        # ONE spread per class: all ten per-CU values on a batch axis
        stacked = torch.stack(
            [hx, hy, vx, vy, base_x, base_y,
             (spread & w_cu).to(torch.int32),
             t.abs_x[:, sl], t.abs_y[:, sl],
             w_cu.to(torch.int32)], dim=1)            # [nCtu, 10, num_cus]
        stacked = torch.where(w_cu[:, None], stacked, 0)
        sp = P.spread_cu_to_slots(stacked, cp_tab,
                                  ct.cu_index)        # [nCtu, 10, NB, NB]
        hxp, hyp, vxp, vyp, bxp, byp = sp[:, :6].unbind(1)
        sprp = sp[:, 6].bool()
        pux, puy = sp[:, 7], sp[:, 8]
        cxs = torch.where(sprp, cp_tab.width // 2, ct.slot_cx)
        cys = torch.where(sprp, cp_tab.height // 2, ct.slot_cy)
        mvx = bxp + hxp * cxs + vxp * cys
        mvy = byp + hyp * cxs + vyp * cys
        # clip bounds use the CU corner position (aux_functions.cl:90-101)
        mvx, mvy = mv_ops.round_and_clip_mv(
            mvx, mvy, pux, puy, spec.frame_w, spec.frame_h)
        wslot = sp[:, 9].bool() & ct.slot_valid
        mvx = torch.where(wslot, mvx, 0)
        mvy = torch.where(wslot, mvy, 0)
        # classes in a bin have disjoint slot coverage and zeros elsewhere,
        # so the merge is a plain sum
        bi = int(t.bin_of[ci])
        for k, v in enumerate((mvy >> 4, mvx >> 4, mvx & 15, mvy & 15)):
            acc[k][bi] = v if acc[k][bi] is None else acc[k][bi] + v
    return tuple(torch.stack(a, dim=1) for a in acc)


def _reduce_pred(spec: PlaneSpec, t: PlaneTables, pred, orig_pl,
                 refine: bool):
    """SATD / gradient / normal-equation reductions from bin pred planes.

    pred: int16 [nCtu, nBins | 1, 128, 128] (a length-1 bin axis
    broadcasts, the zero-MV case).  Returns (satd int64 [nCtu, nCU], M, rhs)
    with M/rhs None unless ``refine``: K2's per-block sums
    (``ops.blockreduce.reduce_blocks``) folded per CU (``_fold_cu``).
    """
    satd_b, moms_b = blockreduce_ops.reduce_blocks(
        pred, orig_pl, t.border_packed, refine, t.repl)
    return _fold_cu(spec, t, satd_b, moms_b, refine)


def _fold_cu(spec: PlaneSpec, t: PlaneTables, satd_b, moms_b, refine: bool):
    """Per-CU SATD and normal equations from K2's per-block sums.

    satd_b int32 [nCtu, nBins, NB, NB]; moms_b int32 [nCtu, nBins, 5, NB,
    NB] block sums of (gx*gx, gx*gy, gy*gy, gx*err, gy*err) — the equation
    model of the JAX package's ops/equations.py (affine.cl:680-694) — or
    None unless ``refine``.  Returns satd int64 [nCtu, nCU] and, with
    ``refine``, M int64 [nCtu, nCU, P, P] and rhs int64 [nCtu, nCU, P]
    (else None, None), canonical class order, zero off-frame.  CUDA inputs
    launch the hand-written kernel once (``ops.cufold``, on
    ``t.fold_lanes`` and ``t.mv_slots``); CPU inputs run the plain version,
    ``_fold_cu_plain``.
    """
    if satd_b.device.type == "cpu":
        return _fold_cu_plain(spec, t, satd_b, moms_b, refine)
    return cufold_ops.fold_cu(satd_b, moms_b, t.within, t.fold_lanes,
                              t.mv_slots, spec.n_cp, refine)


def _fold_cu_plain(spec: PlaneSpec, t: PlaneTables, satd_b, moms_b,
                   refine: bool):
    """The plain version of ``_fold_cu`` (the JAX engine's): per class, the
    SATD blocks masked by ``slot_valid`` and summed over each CU's slots;
    the moments widened to int64 per bin; per class, every unique M and rhs
    term as int64 slot planes, summed the same way; the symmetric entries
    selected, and everything masked by ``within``."""
    satd_cols = []
    for ci, cp_tab in enumerate(t.cls):
        bi = int(t.bin_of[ci])
        satd_cols.append(P.reduce_slots_to_cu(
            torch.where(t.cls_t[ci].slot_valid,
                        satd_b[:, bi].to(torch.int64), 0), cp_tab))
    within = t.within
    satd = torch.where(within, torch.cat(satd_cols, dim=1), 0)
    if not refine:
        return satd, None, None
    # per-block moment sums are int32-exact; widen to int64 per bin here,
    # where the JAX engine widens
    moments = [moms_b[:, bi].to(torch.int64) for bi in range(t.n_bins)]
    Pn = 2 * spec.n_cp
    n_terms = len(_term_order(spec.n_cp))
    M_cols, rhs_cols = [], []
    for ci, cp_tab in enumerate(t.cls):
        m = moments[int(t.bin_of[ci])]
        coef_m, coef_r = t.cls_t[ci].eq[spec.n_cp]
        # every unique M term and rhs term on one axis, so the slot->CU
        # reduction is a single batched sum per class
        terms_m = (m[:, 0:1] * coef_m[0] + m[:, 1:2] * coef_m[1]
                   + m[:, 2:3] * coef_m[2])           # [nCtu, T, NB, NB]
        terms_r = m[:, 3:4] * coef_r[0] + m[:, 4:5] * coef_r[1]
        red = P.reduce_slots_to_cu(
            torch.cat([terms_m, terms_r], dim=1), cp_tab)  # [nCtu, T+P, nCU]
        red = red.transpose(1, 2)                          # [nCtu, nCU, T+P]
        M_cols.append(red.index_select(-1, t.cls_t[ci].sym[spec.n_cp])
                      .unflatten(-1, (Pn, Pn)))
        rhs_cols.append(red[..., n_terms:] << 3)
    M = torch.where(within[..., None, None], torch.cat(M_cols, dim=1), 0)
    rhs = torch.where(within[..., None], torch.cat(rhs_cols, dim=1), 0)
    return satd, M, rhs


def _evaluate(spec: PlaneSpec, t: PlaneTables, ref_flat, orig_pl, cpmvs,
              refine: bool):
    """One prediction pass: warp (K1) then block reduction (K2).

    Returns (satd [nCtu, nCU] int64, M, rhs | None).
    """
    dy, dx, fx, fy = _mv_planes(spec, t, cpmvs)
    pred = warp_ops.warp(ref_flat, spec.frame_w, spec.frame_h, t.ctu_y,
                         t.ctu_x, dy, dx, fx, fy, t.slab_active)
    return _reduce_pred(spec, t, pred, orig_pl, refine)


def _evaluate_zero(spec: PlaneSpec, t: PlaneTables, ref_pl, orig_pl,
                   refine: bool):
    """Iteration-0 evaluate for 2CP stages: CPMVs are all zero
    (affine.cl:53-59), so every block's prediction is the phase-0 filter of
    the co-located reference sample — a closed-form elementwise map of the
    reference plane, identical for every size class.  No warp needed.

    ref_pl: int32 [nCtu, 128, 128] co-located reference CTU tiles.
    """
    tmp = (ref_pl * 64 + warp_ops._OFF1) >> warp_ops._SHIFT1
    p0 = clamp((tmp * 64 + warp_ops._OFF2) >> warp_ops._SHIFT2,
               C.CLP_RNG_MIN, C.CLP_RNG_MAX).to(torch.int16)
    return _reduce_pred(spec, t, p0[:, None], orig_pl, refine)


def _init_cpmvs(spec: PlaneSpec, t: PlaneTables, prev):
    """2CP: zeros (affine.cl:53-59); 3CP: LT/RT from 2CP best + derived LB
    (affine.cl:62-106).  Canonical class order throughout."""
    if spec.n_cp == 2:
        return torch.zeros((prev.shape[0], t.n_cus, 3, 2), dtype=torch.int32,
                           device=prev.device)
    parts = []
    for ci, cp_tab in enumerate(t.cls):
        sl = _class_slice(t, ci)
        cp = prev[:, sl]
        lb = mv_ops.derive_lb_from_2cp(
            cp, int(np.log2(cp_tab.width)), int(np.log2(cp_tab.height)),
            t.abs_x[:, sl], t.abs_y[:, sl], spec.frame_w, spec.frame_h)
        parts.append(torch.cat([cp[..., 0:2, :], lb[..., None, :]], dim=-2))
    return torch.cat(parts, dim=1)


def refine_cpmvs(spec, t, cpmvs, M, rhs):
    """One refinement step: solve the systems, add the scaled deltas,
    clamp and clip (affine.cl:782-893).  ``t`` holds the per-CU ``cu_w``,
    ``cu_h``, ``abs_x`` and ``abs_y`` in the CU order of ``cpmvs`` (either
    engine's tables)."""
    params = solver_ops.solve_affine(M, rhs, spec.n_cp)
    deltas = solver_ops.scale_delta_mvs(params, spec.n_cp, t.cu_w, t.cu_h)
    new = clamp(cpmvs + deltas, C.MV_MIN, C.MV_MAX)
    nx, ny = mv_ops.clip_mv(
        new[..., 0], new[..., 1], t.abs_x[..., None], t.abs_y[..., None],
        spec.frame_w, spec.frame_h)
    return torch.stack([nx, ny], dim=-1)


def prep_inputs(spec: PlaneSpec, t: PlaneTables, ref_flat, orig_flat):
    """Per-CTU 128x128 original and reference planes, int32 [nCtu, 128,
    128], zero-padded past the frame (only within-frame CUs are used); the
    padding CTUs of padded tables get zero planes."""
    oh = 128 * t.n_ctu_y
    ow = 128 * t.n_ctu_x
    n_grid = t.n_ctu_y * t.n_ctu_x

    def to_planes(flat):
        p2d = torch.nn.functional.pad(
            flat.reshape(spec.frame_h, spec.frame_w),
            (0, ow - spec.frame_w, 0, oh - spec.frame_h))
        pl_ = p2d.reshape(t.n_ctu_y, 128, t.n_ctu_x, 128)
        pl_ = pl_.transpose(1, 2).reshape(n_grid, 128, 128)
        if t.n_ctus > n_grid:
            pl_ = torch.cat([pl_, pl_.new_zeros(
                (t.n_ctus - n_grid, 128, 128))])
        return pl_

    return to_planes(orig_flat), to_planes(ref_flat)


def _stage_core(spec: PlaneSpec, t: PlaneTables, ref_flat, orig_pl, ref_pl,
                lam, prev_cpmvs):
    """The iteration loop.  Returns (best_cost, best_cpmvs)."""
    curr = _init_cpmvs(spec, t, prev_cpmvs)
    best_cost = torch.full((curr.shape[0], t.n_cus), int(C.MAX_LONG),
                           dtype=torch.int64, device=curr.device)
    best_cp = torch.zeros_like(curr)

    def update_best(curr, satd, best_cost, best_cp):
        bits = cost_ops.affine_bits_zero_pred(curr, spec.n_cp)
        cost = cost_ops.rd_cost(satd, bits, lam)
        better = cost < best_cost
        return (torch.where(better, cost, best_cost),
                torch.where(better[..., None, None], curr, best_cp))

    n_iters = spec.num_gradient_iters
    if spec.n_cp == 2:
        # iteration 0 in closed form (zero CPMVs)
        satd, M, rhs = _evaluate_zero(spec, t, ref_pl, orig_pl, True)
        best_cost, best_cp = update_best(curr, satd, best_cost, best_cp)
        curr = refine_cpmvs(spec, t, curr, M, rhs)
        n_iters -= 1
    for _ in range(n_iters):
        satd, M, rhs = _evaluate(spec, t, ref_flat, orig_pl, curr, True)
        best_cost, best_cp = update_best(curr, satd, best_cost, best_cp)
        curr = refine_cpmvs(spec, t, curr, M, rhs)
    satd, _, _ = _evaluate(spec, t, ref_flat, orig_pl, curr, False)
    return update_best(curr, satd, best_cost, best_cp)


def check_inputs(t, spec, device, ref_flat, orig_flat, lam, prev):
    """Raise ValueError unless a stage's inputs have the contract's dtypes
    and shapes on ``device`` (``t``: the stage's tables, with ``n_ctus``
    and ``n_cus``; ``spec``: its frame size; either engine's)."""
    n = spec.frame_w * spec.frame_h
    for name, x, dtype, shape in (
            ("ref_flat", ref_flat, torch.int32, (n,)),
            ("orig_flat", orig_flat, torch.int32, (n,)),
            ("lam", lam, torch.float32, ()),
            ("prev_cpmvs", prev, torch.int32, (t.n_ctus, t.n_cus, 3, 2))):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


@functools.lru_cache(maxsize=None)
def eager_stage_fn(spec: PlaneSpec, device: torch.device):
    """``build_stage``'s stage as the eager loop of ops it is built from,
    on ``device``.  On the card it is the oracle that the captured stage is
    held against (``chip_smoke.py``) and what ``tools/profile_stage.py``
    times piece by piece; it is never a fallback for a failed capture.
    ``run.check`` is its input check (``check_inputs``)."""
    tables = build_tables(spec, device)
    check = functools.partial(check_inputs, tables, spec, device)

    def run(ref_flat, orig_flat, lam, prev_cpmvs):
        check(ref_flat, orig_flat, lam, prev_cpmvs)
        orig_pl, ref_pl = prep_inputs(spec, tables, ref_flat, orig_flat)
        return _stage_core(spec, tables, ref_flat, orig_pl, ref_pl, lam,
                           prev_cpmvs)

    run.check = check
    return run


@functools.lru_cache(maxsize=None)
def _stage_fn(spec: PlaneSpec, device: torch.device):
    eager = eager_stage_fn(spec, device)
    return graphs.for_device(eager, device, eager.check)


def build_stage(spec: PlaneSpec, device=None):
    """One dense-engine stage on ``device`` (``cuda`` unless given):
    fn(ref_flat int32 [fh*fw], orig_flat int32 [fh*fw], lam float32 0-d,
    prev_cpmvs int32 [nCtu, nCU, 3, 2]) ->
    (best_cost int64 [nCtu, nCU], best_cpmvs int32 [nCtu, nCU, 3, 2]),
    canonical class order.  Inputs must already be on the device
    (``stage_inputs_from_numpy``).  On a card the stage is one CUDA graph,
    captured at the first call and replayed from the second
    (``runtime.graphs.Graphed``); on the CPU it runs eagerly."""
    return _stage_fn(spec, resolve_device(device))


@functools.lru_cache(maxsize=None)
def eager_pair_fn(spec2: PlaneSpec, spec3: PlaneSpec, device: torch.device):
    """``build_pair_stage``'s pair as its eager loop of ops on ``device``:
    the card's oracle, as ``eager_stage_fn`` is; ``run.check`` is its input
    check."""
    tables = build_tables(spec2, device)   # mode/frame geometry: same for both
    check = functools.partial(check_inputs, tables, spec2, device)

    def run(ref_flat, orig_flat, lam, prev2):
        check(ref_flat, orig_flat, lam, prev2)
        orig_pl, ref_pl = prep_inputs(spec2, tables, ref_flat, orig_flat)
        c2, p2 = _stage_core(spec2, tables, ref_flat, orig_pl, ref_pl, lam,
                             prev2)
        c3, p3 = _stage_core(spec3, tables, ref_flat, orig_pl, ref_pl, lam,
                             p2)
        return c2, p2, c3, p3

    run.check = check
    return run


@functools.lru_cache(maxsize=None)
def _pair_fn(spec2: PlaneSpec, spec3: PlaneSpec, device: torch.device):
    eager = eager_pair_fn(spec2, spec3, device)
    return graphs.for_device(eager, device, eager.check)


def build_pair_stage(spec2: PlaneSpec, spec3: PlaneSpec, device=None):
    """A mode's sequential 2CP -> 3CP chain on ``device``.

    The reference dispatches these as two kernel launches with the 2CP
    result buffer fed to the 3CP kernel as prevCpmvs (main.cpp:759-878, arg
    10 at main.cpp:837); here both stages share one ``prep_inputs``, and on
    a card the whole chain is one CUDA graph (as ``build_stage``), so the
    2CP->3CP CPMV handoff stays on the device.
    fn(ref_flat, orig_flat, lam, prev2) -> (cost2, cpmvs2, cost3, cpmvs3).
    """
    if not (spec2.mode == spec3.mode and spec2.n_cp == 2
            and spec3.n_cp == 3):
        raise ValueError("build_pair_stage takes a mode's 2CP and 3CP specs")
    return _pair_fn(spec2, spec3, resolve_device(device))


def zero_cpmvs(spec: PlaneSpec, device=None) -> torch.Tensor:
    lay = G.layout(spec.mode)
    n = G.frame_grid(spec.frame_w, spec.frame_h).num_ctus
    return torch.zeros((n, lay.cus_per_ctu, 3, 2), dtype=torch.int32,
                       device=resolve_device(device))


def stage_inputs_from_numpy(ref_flat, orig_flat, lam, prev_cpmvs, device):
    """Stage inputs on ``device`` from host values: int32 frames of 10-bit
    samples (``check_samples``), a float32 0-d lambda (the RD cost
    multiplies in float32) and int32 CPMVs."""
    check_samples(ref_flat, "ref_flat")
    check_samples(orig_flat, "orig_flat")
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(ref_flat, np.int32).reshape(-1),
                            device=dev),
            torch.as_tensor(np.asarray(orig_flat, np.int32).reshape(-1),
                            device=dev),
            torch.tensor(np.float32(lam), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(prev_cpmvs, np.int32), device=dev))
