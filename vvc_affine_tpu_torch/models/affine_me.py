"""The gather Affine-ME engine (``--Engine gather``), in PyTorch.

Port of the JAX package's ``models/affine_me.py``.  A stage evaluates, for
every CU of every size class in every CTU of a frame,
``numGradientIter+1`` rounds of: affine MC prediction of all 4x4 sub-blocks
-> SATD -> RD cost -> best-CPMV update, interleaved with gradient/optical-
flow CPMV refinement (Sobel -> normal equations -> VTM LS solve -> delta
CPMVs).  Behavioural spec: the affine_gradient_mult_sizes(_HA) kernels
(affine.cl:11-958, 960-1950) and their dispatch contract
(main.cpp:746-1010).

Structure:
  * CUs of equal size across all classes are merged into compute groups
    (``geometry.ComputeClass``), so an evaluate loops over 12 (aligned) /
    8 (half-aligned) groups; each group's windows and planes are freed
    before the next group's are made.
  * State lives as dense tensors [nCtu, nCU, ...] in merged-group order and
    is permuted to canonical class order at the end.
  * The iteration loop is ``num_gradient_iters`` rounds of (evaluate +
    refine) followed by one final evaluate.
  * Out-of-frame CUs (partial bottom/right CTUs) contribute zero SATD and a
    zeroed equation system (affine.cl:192-208).

The engine is plain PyTorch ops on any device: it shares no kernel with
the plane engine (``affine_plane``), so on the card its decisions are an
independent check of K1 and K2.  On a card each stage is one CUDA graph of
those ops, captured at its first call and replayed after
(``runtime.graphs``, the counterpart of the JAX engine's jitted stage); on
the CPU the ops run eagerly.  PROF is computed-but-disabled in the
reference (enablePROF=0, affine.cl:168), so it is not on the prediction
path; ``ops/prof.py`` holds it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import geometry as G
from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_plane
from vvc_affine_tpu_torch.ops import cost as cost_ops
from vvc_affine_tpu_torch.ops import equations as eq_ops
from vvc_affine_tpu_torch.ops import gradient as grad_ops
from vvc_affine_tpu_torch.ops import interp as interp_ops
from vvc_affine_tpu_torch.ops import mv as mv_ops
from vvc_affine_tpu_torch.ops import satd as satd_ops
from vvc_affine_tpu_torch.runtime import graphs


@dataclass(frozen=True)
class StageSpec:
    mode: str          # 'full' (aligned CUs) | 'half' (half-aligned CUs)
    n_cp: int          # 2 or 3 control points
    frame_w: int
    frame_h: int
    extra_iters: int = 0

    @property
    def num_gradient_iters(self) -> int:
        # affine.cl:172-177
        return (5 if self.n_cp == 2 else 4) + self.extra_iters


class GroupTables(NamedTuple):
    """Static tables of one compute group (all CUs of one (w, h))."""

    offset: int          # column offset of this group in merged order
    n_cus: int
    w: int
    h: int
    log2w: int
    log2h: int
    sub_x: torch.Tensor  # int32 [S] sub-block corners, CU-relative raster
    sub_y: torch.Tensor
    factors: eq_ops.SubblockFactors  # int64 tensors (numpy in _tables_numpy)


class StageTables(NamedTuple):
    n_ctus: int
    n_cus: int                     # CUs per CTU (201 / 284)
    groups: Tuple[GroupTables, ...]
    merged_order: torch.Tensor     # int32 canonical idx of each merged column
    to_canonical: torch.Tensor     # int32 merged idx of each canonical column
    cu_w: torch.Tensor             # int32 [nCU] (merged order)
    cu_h: torch.Tensor
    abs_x: torch.Tensor            # int32 [nCtu, nCU] absolute CU corners
    abs_y: torch.Tensor
    within: torch.Tensor           # bool  [nCtu, nCU]


# StageTables fields that are tensors, with the dtype each is built from
_TENSOR_DTYPES = {"merged_order": np.int32, "to_canonical": np.int32,
                  "cu_w": np.int32, "cu_h": np.int32, "abs_x": np.int32,
                  "abs_y": np.int32, "within": np.bool_}


def _tables_numpy(spec: StageSpec, n_ctu_pad: int = 0) -> dict:
    """The JAX engine's StageTables fields (numpy) for this geometry.

    With ``n_ctu_pad`` the CTU axis is padded to that many entries; padded
    CTUs sit at (frame_w, frame_h), so every padded CU fails the in-frame
    test and takes the zero-SATD/zero-system path.
    """
    lay = G.layout(spec.mode)
    grid = G.frame_grid(spec.frame_w, spec.frame_h)
    ctu_x, ctu_y = grid.ctu_origin()
    if n_ctu_pad > grid.num_ctus:
        extra = n_ctu_pad - grid.num_ctus
        ctu_x = np.concatenate([ctu_x, np.full(extra, spec.frame_w, np.int32)])
        ctu_y = np.concatenate([ctu_y, np.full(extra, spec.frame_h, np.int32)])

    groups = []
    merged_order = []
    off = 0
    for g in lay.compute_classes:
        sw, sh = g.sb_cols, g.sb_rows
        groups.append(GroupTables(
            offset=off, n_cus=g.num_cus, w=g.width, h=g.height,
            log2w=int(np.log2(g.width)), log2h=int(np.log2(g.height)),
            sub_x=np.tile(np.arange(sw, dtype=np.int32) * 4, sh),
            sub_y=np.repeat(np.arange(sh, dtype=np.int32) * 4, sw),
            factors=eq_ops.subblock_factors(sh, sw, spec.n_cp)))
        merged_order.extend(g.cu_flat_idx)
        off += g.num_cus
    merged = np.asarray(merged_order, np.int32)
    to_canonical = np.empty_like(merged)
    to_canonical[merged] = np.arange(len(merged), dtype=np.int32)

    cu_w = lay.cu_w[merged]
    cu_h = lay.cu_h[merged]
    abs_x = ctu_x[:, None] + lay.cu_x[merged][None, :]
    abs_y = ctu_y[:, None] + lay.cu_y[merged][None, :]
    within = (abs_x + cu_w[None, :] <= spec.frame_w) & (
        abs_y + cu_h[None, :] <= spec.frame_h)
    return dict(
        n_ctus=max(grid.num_ctus, n_ctu_pad), n_cus=lay.cus_per_ctu,
        groups=groups, merged_order=merged, to_canonical=to_canonical,
        cu_w=cu_w, cu_h=cu_h, abs_x=abs_x, abs_y=abs_y, within=within)


def tables_from_numpy(d: dict, device) -> StageTables:
    """StageTables on ``device`` from the JAX StageTables fields.

    ``d`` maps field names to ints and numpy arrays (the JAX engine's
    ``StageTables._asdict()`` or ``_tables_numpy``); its groups are
    ``GroupTables`` of either package, holding numpy arrays and numpy
    ``SubblockFactors``.  Every tensor is built from a numpy array of an
    explicit dtype: int32 tables, bool ``within``, int64 factors.
    """
    groups = []
    for group in d["groups"]:
        g = group._asdict()
        groups.append(GroupTables(
            **{k: int(g[k]) for k in ("offset", "n_cus", "w", "h", "log2w",
                                      "log2h")},
            sub_x=torch.as_tensor(np.asarray(g["sub_x"], np.int32),
                                  device=device),
            sub_y=torch.as_tensor(np.asarray(g["sub_y"], np.int32),
                                  device=device),
            factors=eq_ops.factors_to(g["factors"], device)))
    return StageTables(
        n_ctus=int(d["n_ctus"]), n_cus=int(d["n_cus"]), groups=tuple(groups),
        **{k: torch.as_tensor(np.asarray(d[k], dt), device=device)
           for k, dt in _TENSOR_DTYPES.items()})


def build_tables(spec: StageSpec, n_ctu_pad: int = 0,
                 device=None) -> StageTables:
    """Static tables on ``device`` (``cuda`` unless given), the CTU axis
    optionally padded to ``n_ctu_pad`` entries (``_tables_numpy``)."""
    return tables_from_numpy(_tables_numpy(spec, n_ctu_pad),
                             resolve_device(device))


def ctu_rows(t: StageTables, lo: int, hi: int) -> StageTables:
    """CTUs [lo, hi) of ``t``: views of the per-CTU fields (``abs_x``,
    ``abs_y``, ``within``), the static fields shared."""
    return t._replace(n_ctus=hi - lo, abs_x=t.abs_x[lo:hi],
                      abs_y=t.abs_y[lo:hi], within=t.within[lo:hi])


def _init_cpmvs(spec: StageSpec, t: StageTables, prev_canonical):
    """Initial CPMVs in merged order.

    2CP: zeros (affine.cl:53-59).  3CP: LT/RT inherited from the 2CP best,
    LB derived by the rotation model per group (affine.cl:62-106).
    """
    if spec.n_cp == 2:
        return torch.zeros((t.n_ctus, t.n_cus, 3, 2), dtype=torch.int32,
                           device=prev_canonical.device)
    prev = prev_canonical.index_select(1, t.merged_order)
    parts = []
    for g in t.groups:
        sl = slice(g.offset, g.offset + g.n_cus)
        cp = prev[:, sl]
        lb = mv_ops.derive_lb_from_2cp(
            cp, g.log2w, g.log2h, t.abs_x[:, sl], t.abs_y[:, sl],
            spec.frame_w, spec.frame_h)
        parts.append(torch.cat([cp[..., 0:2, :], lb[..., None, :]], dim=-2))
    return torch.cat(parts, dim=1)


def _evaluate(spec: StageSpec, t: StageTables, ref_flat, orig_flat, cpmvs,
              refine: bool):
    """One prediction pass over every CU; optionally build the LS systems.

    Returns (satd int64 [nCtu, nCU], M int64 [nCtu, nCU, P, P] | None,
    rhs int64 [nCtu, nCU, P] | None), merged order.
    """
    fw, fh = spec.frame_w, spec.frame_h
    satds, Ms, rhss = [], [], []
    for g in t.groups:
        sl = slice(g.offset, g.offset + g.n_cus)
        mvx, mvy, _ = mv_ops.derive_sub_mvs(
            cpmvs[:, sl], g.log2w, g.log2h, spec.n_cp, g.sub_x, g.sub_y)
        gx_cu = t.abs_x[:, sl, None]
        gy_cu = t.abs_y[:, sl, None]
        mvx, mvy = mv_ops.round_and_clip_mv(mvx, mvy, gx_cu, gy_cu, fw, fh)
        bx = gx_cu + g.sub_x
        by = gy_cu + g.sub_y
        pred = interp_ops.predict_subblocks(ref_flat, fw, fh, bx, by, mvx, mvy)
        orig = interp_ops.gather_blocks(orig_flat, fw, fh, bx, by)
        w_g = t.within[:, sl]
        # widen before the per-CU sum (affine_me.py:205 of the JAX engine)
        satds.append(torch.where(
            w_g, satd_ops.satd_4x4(orig, pred).to(torch.int64).sum(-1), 0))
        if refine:
            def planes(blocks):
                lead = blocks.shape[:2]
                x = blocks.reshape(lead + (g.h // 4, g.w // 4, 4, 4))
                return x.transpose(3, 4).reshape(lead + (g.h, g.w))

            pred_pl = planes(pred)
            gx, gy = grad_ops.sobel_cu(pred_pl)
            mom = eq_ops.gradient_moments(gx, gy, planes(orig) - pred_pl)
            M, rhs = eq_ops.assemble_system(*mom, g.factors)
            Ms.append(torch.where(w_g[..., None, None], M, 0))
            rhss.append(torch.where(w_g[..., None], rhs, 0))
    satd = torch.cat(satds, dim=1)
    if refine:
        return satd, torch.cat(Ms, dim=1), torch.cat(rhss, dim=1)
    return satd, None, None


def _cost(spec: StageSpec, cpmvs, satd, lam):
    bits = cost_ops.affine_bits_zero_pred(cpmvs, spec.n_cp)
    return cost_ops.rd_cost(satd, bits, lam)


def _stage_run(spec: StageSpec, t: StageTables, ref_flat, orig_flat, lam,
               prev_canonical):
    """The iteration loop.  Returns (best_cost int64, best_cpmvs int32),
    canonical class order."""
    curr = _init_cpmvs(spec, t, prev_canonical)
    best_cost = torch.full((t.n_ctus, t.n_cus), int(C.MAX_LONG),
                           dtype=torch.int64, device=curr.device)
    best_cp = torch.zeros_like(curr)

    def update_best(curr, satd, best_cost, best_cp):
        cost = _cost(spec, curr, satd, lam)
        better = cost < best_cost      # strict: the first minimum is kept
        return (torch.where(better, cost, best_cost),
                torch.where(better[..., None, None], curr, best_cp))

    for _ in range(spec.num_gradient_iters):
        satd, M, rhs = _evaluate(spec, t, ref_flat, orig_flat, curr, True)
        best_cost, best_cp = update_best(curr, satd, best_cost, best_cp)
        curr = affine_plane.refine_cpmvs(spec, t, curr, M, rhs)
    # final evaluation of the last refined CPMVs (no refinement after)
    satd, _, _ = _evaluate(spec, t, ref_flat, orig_flat, curr, False)
    best_cost, best_cp = update_best(curr, satd, best_cost, best_cp)
    # merged order -> canonical class order (the output contract)
    return (best_cost.index_select(1, t.to_canonical),
            best_cp.index_select(1, t.to_canonical))


@functools.lru_cache(maxsize=None)
def eager_stage_fn(spec: StageSpec, device: torch.device):
    """``build_stage``'s stage as the eager loop of ops it is built from,
    on ``device``.  On the card it is the oracle that the captured stage is
    held against (``chip_smoke.py``); it is never a fallback for a failed
    capture.  ``run.check`` is its input check
    (``affine_plane.check_inputs``)."""
    tables = build_tables(spec, device=device)
    check = functools.partial(affine_plane.check_inputs, tables, spec, device)

    def run(ref_flat, orig_flat, lam, prev_cpmvs):
        check(ref_flat, orig_flat, lam, prev_cpmvs)
        return _stage_run(spec, tables, ref_flat, orig_flat, lam, prev_cpmvs)

    run.check = check
    return run


@functools.lru_cache(maxsize=None)
def _stage_fn(spec: StageSpec, device: torch.device):
    eager = eager_stage_fn(spec, device)
    return graphs.for_device(eager, device, eager.check)


def build_stage(spec: StageSpec, device=None):
    """One gather-engine stage on ``device`` (``cuda`` unless given):
    fn(ref_flat int32 [fh*fw], orig_flat int32 [fh*fw], lam float32 0-d,
    prev_cpmvs int32 [nCtu, nCU, 3, 2]) ->
    (best_cost int64 [nCtu, nCU], best_cpmvs int32 [nCtu, nCU, 3, 2]), both
    in canonical class order: the plane engine's contract and outputs.  For
    2CP stages ``prev_cpmvs`` is ignored (pass ``zero_cpmvs``).  On a card
    the stage is one CUDA graph, captured at the first call and replayed
    from the second (``runtime.graphs.Graphed``); on the CPU it runs
    eagerly."""
    return _stage_fn(spec, resolve_device(device))


def zero_cpmvs(spec: StageSpec, device=None) -> torch.Tensor:
    lay = G.layout(spec.mode)
    n = G.frame_grid(spec.frame_w, spec.frame_h).num_ctus
    return torch.zeros((n, lay.cus_per_ctu, 3, 2), dtype=torch.int32,
                       device=resolve_device(device))
