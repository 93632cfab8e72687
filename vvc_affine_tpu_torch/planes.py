"""Per-class CTU-plane tables for the dense (gather-free) engine.

The dense engine evaluates each CU size class as a full 128x128 CTU plane:
every 4x4 block slot of the plane carries its owning CU's motion/coefficient
data, prediction runs as dense vector ops, and per-CU results come back out
through static strided reductions.  These tables describe, per canonical
class (12 aligned / 24 half-aligned — geometry.layout order, which is the
reference's return-array contract, constants.cl WIDTH_LIST/HA_WIDTH_LIST):

* how CU-level values spread onto the 32x32 block-slot grid (sub-grids), and
  conversely how slot-level values reduce back to per-CU sums;
* per-slot static data: validity, CU-relative sub-block centres (cx, cy)
  used by the normal equations (affine.cl:680-694), and CU border masks used
  by the Sobel border replication (affine.cl:506-540).

Every class except 16x16_U123 is a single uniform cross-product grid of CUs;
U123 (half-aligned, constants.cl HA 16x16 U group) decomposes into three
uniform sub-grids.  All placements/reductions are therefore static strided
slices — no gathers anywhere.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from vvc_affine_tpu_torch import geometry as G

NB = 32  # block slots per CTU axis (128 / 4)


@dataclass(frozen=True)
class SubGrid:
    """A uniform ny x nx grid of equally-sized CUs of one class."""

    cu_ids: Tuple[int, ...]   # canonical CU index within the class, raster
    by0: int                  # first CU's block-row
    bystep: int               # block-rows between CU origins
    ny: int
    bx0: int
    bxstep: int
    nx: int
    sbh: int                  # block-rows per CU (h / 4)
    sbw: int                  # block-cols per CU (w / 4)


@dataclass(frozen=True)
class ClassPlane:
    """Static plane-form tables for one canonical CU size class."""

    class_id: int
    width: int
    height: int
    num_cus: int
    subgrids: Tuple[SubGrid, ...]
    # [NB, NB] slot tables (block-slot granularity)
    slot_valid: np.ndarray      # bool: slot belongs to some CU of this class
    slot_cx: np.ndarray         # int32: CU-relative sub-block centre x (affine.cl:680)
    slot_cy: np.ndarray         # int32
    # [128] sample-granularity CU border masks for Sobel replication
    row_top: np.ndarray         # bool: sample row is the top row of its CU
    row_bot: np.ndarray
    col_left: np.ndarray
    col_right: np.ndarray


def _subgrids_for(c: G.CuClass) -> List[SubGrid]:
    ux, uy = sorted(set(c.xs)), sorted(set(c.ys))

    def stride(v, ext):
        return (v[1] - v[0]) if len(v) > 1 else ext

    if len(c.xs) == len(ux) * len(uy):
        dxs = np.diff(ux) if len(ux) > 1 else np.array([c.width])
        dys = np.diff(uy) if len(uy) > 1 else np.array([c.height])
        if (dxs == dxs[0]).all() and (dys == dys[0]).all():
            return [SubGrid(
                cu_ids=tuple(range(len(c.xs))),
                by0=uy[0] // 4, bystep=stride(uy, c.height) // 4, ny=len(uy),
                bx0=ux[0] // 4, bxstep=stride(ux, c.width) // 4, nx=len(ux),
                sbh=c.height // 4, sbw=c.width // 4,
            )]
    if c.name != "16x16_U123":
        raise ValueError(f"unexpected irregular class {c.name}")
    # U123 = three uniform sub-grids (geometry.py builds it row-major):
    #   rows {8,40,72,104} x cols {8,24,40}; same rows x cols {72,88,104};
    #   rows {24,88} x cols {8,40,72,104}.
    pos = {(x, y): i for i, (x, y) in enumerate(zip(c.xs, c.ys))}

    def grid(xs, ys):
        ids = tuple(pos[(x, y)] for y in ys for x in xs)
        return SubGrid(
            cu_ids=ids,
            by0=ys[0] // 4, bystep=(ys[1] - ys[0]) // 4, ny=len(ys),
            bx0=xs[0] // 4, bxstep=(xs[1] - xs[0]) // 4, nx=len(xs),
            sbh=4, sbw=4,
        )

    return [
        grid((8, 24, 40), (8, 40, 72, 104)),
        grid((72, 88, 104), (8, 40, 72, 104)),
        grid((8, 40, 72, 104), (24, 88)),
    ]


def _class_plane(ci: int, c: G.CuClass) -> ClassPlane:
    grids = _subgrids_for(c)
    valid = np.zeros((NB, NB), bool)
    cx = np.zeros((NB, NB), np.int32)
    cy = np.zeros((NB, NB), np.int32)
    row_top = np.zeros(128, bool)
    row_bot = np.zeros(128, bool)
    col_left = np.zeros(128, bool)
    col_right = np.zeros(128, bool)
    for x0, y0 in zip(c.xs, c.ys):
        b0x, b0y = x0 // 4, y0 // 4
        sh, sw = c.height // 4, c.width // 4
        valid[b0y:b0y + sh, b0x:b0x + sw] = True
        # per-sample coefficients use the sub-block centre relative to the CU
        # corner: cx = 4*subcol + 2, cy = 4*subrow + 2 (affine.cl:680-681)
        cx[b0y:b0y + sh, b0x:b0x + sw] = (np.arange(sw) * 4 + 2)[None, :]
        cy[b0y:b0y + sh, b0x:b0x + sw] = (np.arange(sh) * 4 + 2)[:, None]
        row_top[y0] = True
        row_bot[y0 + c.height - 1] = True
        col_left[x0] = True
        col_right[x0 + c.width - 1] = True
    return ClassPlane(
        class_id=ci, width=c.width, height=c.height, num_cus=c.num_cus,
        subgrids=tuple(grids), slot_valid=valid, slot_cx=cx, slot_cy=cy,
        row_top=row_top, row_bot=row_bot, col_left=col_left,
        col_right=col_right,
    )


@functools.lru_cache(maxsize=None)
def plane_layout(mode: str) -> Tuple[ClassPlane, ...]:
    lay = G.layout(mode)
    return tuple(_class_plane(ci, c) for ci, c in enumerate(lay.classes))


# ---------------------------------------------------------------------------
# spread / reduce between per-CU tensors and slot planes (static slices; the
# CU ids of 16x16_U123's sub-grids come from device tables, subgrid_index)
# ---------------------------------------------------------------------------

def subgrid_index(cp: ClassPlane,
                  device) -> Tuple[Optional[torch.Tensor], ...]:
    """Per sub-grid of ``cp``, its CU ids as an int64 tensor on ``device``,
    or None where they are 0..n-1 in order (every class but 16x16_U123).

    Built once with the tables: indexing with a Python list copies the
    list to the device on every call, which a CUDA graph cannot capture.
    """
    return tuple(
        None if g.cu_ids == tuple(range(len(g.cu_ids)))
        else torch.tensor(g.cu_ids, dtype=torch.int64, device=device)
        for g in cp.subgrids)


def spread_cu_to_slots(vals: torch.Tensor, cp: ClassPlane,
                       index: Tuple[Optional[torch.Tensor], ...]
                       ) -> torch.Tensor:
    """Per-CU values -> [..., NB, NB] slot plane (invalid slots zero).

    vals: [..., num_cus] (class-canonical raster order); ``index``:
    ``subgrid_index(cp, vals.device)``.  Each CU's value is written into its
    sbh x sbw block of slots on a fresh zeros plane by slice assignment: one
    slice per contiguous sub-grid, one per CU where the CUs of a sub-grid
    leave gaps between them.
    """
    batch = vals.shape[:-1]
    plane = vals.new_zeros(batch + (NB, NB))
    for g, idx in zip(cp.subgrids, index, strict=True):
        # [..., ny*nx]
        v = vals if idx is None else vals.index_select(-1, idx)
        v = v.reshape(batch + (g.ny, 1, g.nx, 1)).expand(
            batch + (g.ny, g.sbh, g.nx, g.sbw))
        if g.bystep == g.sbh and g.bxstep == g.sbw:
            plane[..., g.by0: g.by0 + g.ny * g.sbh,
                  g.bx0: g.bx0 + g.nx * g.sbw] = v.reshape(
                batch + (g.ny * g.sbh, g.nx * g.sbw))
            continue
        for ky in range(g.ny):
            y0 = g.by0 + ky * g.bystep
            for kx in range(g.nx):
                x0 = g.bx0 + kx * g.bxstep
                plane[..., y0:y0 + g.sbh, x0:x0 + g.sbw] = v[..., ky, :, kx, :]
    return plane


def reduce_slots_to_cu(plane: torch.Tensor, cp: ClassPlane) -> torch.Tensor:
    """[..., NB, NB] slot plane -> per-CU sums [..., num_cus] (raster)."""
    batch = plane.shape[:-2]
    out = [None] * cp.num_cus
    for g in cp.subgrids:
        if g.bystep == g.sbh and g.bxstep == g.sbw:
            blk = plane[..., g.by0: g.by0 + g.ny * g.sbh,
                        g.bx0: g.bx0 + g.nx * g.sbw]
            sums = blk.reshape(batch + (g.ny, g.sbh, g.nx, g.sbw)).sum(
                dim=(-3, -1))                              # [..., ny, nx]
            for i, cid in enumerate(g.cu_ids):
                out[cid] = sums[..., i // g.nx, i % g.nx]
            continue
        for i, cid in enumerate(g.cu_ids):
            y0 = g.by0 + (i // g.nx) * g.bystep
            x0 = g.bx0 + (i % g.nx) * g.bxstep
            out[cid] = plane[..., y0:y0 + g.sbh, x0:x0 + g.sbw].sum(
                dim=(-2, -1))
    return torch.stack(out, dim=-1)


# rows of ``bin_slot_table``
SLOT_ROWS = ("cls", "cu", "cx", "cy", "log2w", "log2h")


def bin_slot_table(mode: str) -> np.ndarray:
    """Per 4x4 block of every bin plane, the data of the one CU covering
    it: int32 [len(SLOT_ROWS), n_bins, NB, NB].

    Rows: the class (-1 where no class of the bin covers the block), the
    CU's canonical index within the CTU (class stride + index in the class,
    -1 where uncovered), the slot's sub-block centre ``slot_cx`` /
    ``slot_cy`` and log2 of the class's width and height (0 where
    uncovered).  Classes in a bin are disjoint (``bin_layout``), and each
    CU covers the blocks ``spread_cu_to_slots`` writes its value to.  The
    motion-plane kernel (``csrc/mvplanes.cu``) reads it in place of the
    per-class spreads.
    """
    lay = G.layout(mode)
    _, bin_of = bin_layout(mode)
    tab = np.zeros((len(SLOT_ROWS), int(bin_of.max()) + 1, NB, NB), np.int32)
    tab[:2] = -1
    for ci, cp in enumerate(plane_layout(mode)):
        rows = tab[:, int(bin_of[ci])]
        for g in cp.subgrids:
            for i, cid in enumerate(g.cu_ids):
                y0 = g.by0 + (i // g.nx) * g.bystep
                x0 = g.bx0 + (i % g.nx) * g.bxstep
                rows[:2, y0:y0 + g.sbh, x0:x0 + g.sbw] = np.array(
                    [ci, lay.return_strides[ci] + cid])[:, None, None]
        v = cp.slot_valid
        rows[2][v] = cp.slot_cx[v]
        rows[3][v] = cp.slot_cy[v]
        rows[4][v] = int(np.log2(cp.width))
        rows[5][v] = int(np.log2(cp.height))
    return tab


# rows of ``fold_lane_table``
LANE_ROWS = ("cu", "cls", "bin", "by0", "bx", "sbh", "sbw")


def fold_lane_table(mode: str) -> np.ndarray:
    """The CU fold's lanes: int32 [len(LANE_ROWS), n_lanes], one lane per
    block column of every canonical CU, for one CTU.

    Rows: the CU's canonical index within the CTU, its class and bin, the
    first block row ``by0`` of its slot rectangle, the lane's block column
    ``bx``, and the rectangle's height ``sbh`` and width ``sbw`` in blocks.
    A CU's ``sbw`` lanes are consecutive, in column order, and start at a
    multiple of ``sbw`` (a power of two up to 32), so that no CU straddles
    a warp of 32 lanes; ``n_lanes`` is a multiple of 32.  Lanes run bin by
    bin, the classes of a bin by falling width, each class's CUs sub-grid
    by sub-grid, which aligns every CU in both layouts (anything else
    raises ValueError).  The CU fold kernel (``csrc/cufold.cu``) runs one
    thread per (CTU, lane); the slot centres and classes it reads per block
    are ``bin_slot_table``'s.
    """
    lay = G.layout(mode)
    bins, _ = bin_layout(mode)
    cls = plane_layout(mode)
    lanes: List[List[int]] = []
    for bi, ids in enumerate(bins):
        for ci in sorted(ids, key=lambda c: (-cls[c].width, c)):
            for g in cls[ci].subgrids:
                for i, cid in enumerate(g.cu_ids):
                    y0 = g.by0 + (i // g.nx) * g.bystep
                    x0 = g.bx0 + (i % g.nx) * g.bxstep
                    if len(lanes) % g.sbw:
                        raise ValueError(f"{mode}: class {ci} CU {cid} "
                                         f"is not aligned to its width")
                    lanes += [[lay.return_strides[ci] + cid, ci, bi, y0,
                               x0 + k, g.sbh, g.sbw] for k in range(g.sbw)]
    if len(lanes) % 32:
        raise ValueError(f"{mode}: {len(lanes)} lanes, not whole warps")
    return np.array(lanes, np.int32).T.copy()


@functools.lru_cache(maxsize=None)
def bin_layout(mode: str):
    """Pack classes with disjoint slot coverage into shared evaluation bins.

    Half-aligned classes cover 25-50% of the CTU plane each (9x total
    coverage over 24 classes); packing mutually-disjoint classes into one
    plane cuts the dense-warp work from 24 to 16 plane-evaluations per CTU.
    Aligned classes all have full coverage, so bins == classes there.

    Returns (bins, bin_of): bins = tuple of tuples of class ids; bin_of =
    int array [n_classes].
    """
    cls = plane_layout(mode)
    order = sorted(range(len(cls)), key=lambda i: -int(cls[i].slot_valid.sum()))
    bins: List[Tuple[np.ndarray, List[int]]] = []
    for i in order:
        cands = [
            (int(b[0].sum()), bi)
            for bi, b in enumerate(bins)
            if not (b[0] & cls[i].slot_valid).any()
        ]
        if cands:
            _, bi = max(cands)
            bins[bi] = (bins[bi][0] | cls[i].slot_valid, bins[bi][1] + [i])
        else:
            bins.append((cls[i].slot_valid.copy(), [i]))
    bin_of = np.zeros(len(cls), np.int32)
    out = []
    for bi, (_, ids) in enumerate(bins):
        for ci in ids:
            bin_of[ci] = bi
        out.append(tuple(sorted(ids)))
    return tuple(out), bin_of
