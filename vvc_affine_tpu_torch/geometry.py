"""CU geometry generator for aligned and half-aligned affine block layouts.

The reference engine hardcodes CU placement tables (constants.cl:74-435,
constants.h:105-512).  Here the same layouts are *generated* from compact
split-pattern descriptors:

* Aligned CUs tile the 128x128 CTU perfectly for each supported (w, h) —
  12 size classes, 201 CUs per CTU.
* Half-aligned CUs are offset by half their dimension, as produced by VVC
  split trees (QT/TH/TV/BH/BV sequences) — 24 size classes (some sizes appear
  in several "groups", one per distinct split sequence), 284 CUs per CTU.
  All groups except 16x16-U123 are cross products of an x-offset list and a
  y-offset list; U123 interleaves two x-lists across rows.

The class ORDER is part of the engine's output contract (it defines the
return-array strides and the decision-log file layout), so it matches the
reference's enumeration (constants.cl WIDTH_LIST/HA_WIDTH_LIST order).

For batched execution, classes sharing the same (w, h) are merged into "compute
classes" so each jitted stage loops over 12 (aligned) or 8 (half-aligned)
static-shape groups; permutation tables map merged results back to the
canonical per-class CU order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

CTU_W = 128
CTU_H = 128
SB = 4  # sub-block size


@dataclass(frozen=True)
class CuClass:
    """One CU size class: a set of equally-sized CUs placed inside a CTU."""

    name: str
    width: int
    height: int
    # CU corner positions inside the CTU, raster (y-major) order.
    xs: Tuple[int, ...]
    ys: Tuple[int, ...]

    @property
    def num_cus(self) -> int:
        return len(self.xs)

    @property
    def size_str(self) -> str:
        return f"{self.width}x{self.height}"


def _cross(xs: Sequence[int], ys: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Raster-order (y-major) cross product of column and row offsets."""
    px, py = [], []
    for y in ys:
        for x in xs:
            px.append(x)
            py.append(y)
    return tuple(px), tuple(py)


def _aligned_classes() -> List[CuClass]:
    """The 12 aligned CU sizes in the engine's canonical order."""
    sizes = [
        (128, 128), (128, 64), (64, 128),
        (64, 64), (64, 32), (32, 64),
        (32, 32),
        (64, 16), (16, 64),
        (32, 16), (16, 32),
        (16, 16),
    ]
    classes = []
    for w, h in sizes:
        xs, ys = _cross(range(0, CTU_W, w), range(0, CTU_H, h))
        classes.append(CuClass(f"{w}x{h}", w, h, xs, ys))
    return classes


def _half_aligned_classes() -> List[CuClass]:
    """The 24 half-aligned CU groups in the engine's canonical order.

    Offsets are half the CU dimension (or combinations thereof) produced by
    the corresponding split sequences; grid periods follow from the splits.
    """

    def grid(name, w, h, xs, ys):
        px, py = _cross(xs, ys)
        return CuClass(name, w, h, px, py)

    half = []
    # -- G groups (power-of-two CU counts) ----------------------------------
    half.append(grid("64x32", 64, 32, (0, 64), (16, 80)))            # QT-TH
    half.append(grid("32x64", 32, 64, (16, 80), (0, 64)))            # QT-TV
    half.append(grid("64x16_G1", 64, 16, (0, 64), (8, 40, 72, 104)))  # QT-BH-TH
    half.append(grid("64x16_G2", 64, 16, (0, 64), (24, 88)))          # QT-TH-TH
    half.append(grid("16x64_G1", 16, 64, (8, 40, 72, 104), (0, 64)))  # QT-BV-TV
    half.append(grid("16x64_G2", 16, 64, (24, 88), (0, 64)))          # QT-TV-TV
    half.append(grid("32x32_G1", 32, 32, (16, 80), (0, 32, 64, 96)))  # QT-TV-BH
    half.append(grid("32x32_G2", 32, 32, (0, 32, 64, 96), (16, 80)))  # QT-TH-BV
    half.append(grid("32x16_G1", 32, 16, (0, 32, 64, 96), (8, 40, 72, 104)))
    half.append(grid("32x16_G2", 32, 16, (0, 32, 64, 96), (24, 88)))
    half.append(grid("32x16_G3", 32, 16, (16, 80), tuple(range(0, 128, 16))))
    half.append(grid("16x32_G1", 16, 32, (8, 40, 72, 104), (0, 32, 64, 96)))
    half.append(grid("16x32_G2", 16, 32, (24, 88), (0, 32, 64, 96)))
    half.append(grid("16x32_G3", 16, 32, tuple(range(0, 128, 16)), (16, 80)))
    half.append(grid("16x16_G1", 16, 16, tuple(range(0, 128, 16)), (8, 40, 72, 104)))
    half.append(grid("16x16_G2", 16, 16, (8, 40, 72, 104), tuple(range(0, 128, 16))))
    half.append(grid("16x16_G3", 16, 16, tuple(range(0, 128, 16)), (24, 88)))
    half.append(grid("16x16_G4", 16, 16, (24, 88), tuple(range(0, 128, 16))))
    # -- U groups (doubly half-aligned) --------------------------------------
    half.append(grid("32x32_U1", 32, 32, (16, 80), (16, 80)))
    half.append(grid("32x16_U1", 32, 16, (16, 80), (8, 40, 72, 104)))
    half.append(grid("32x16_U2", 32, 16, (16, 80), (24, 88)))
    half.append(grid("16x32_U1", 16, 32, (8, 40, 72, 104), (16, 80)))
    half.append(grid("16x32_U2", 16, 32, (24, 88), (16, 80)))
    # 16x16_U123: rows at y in {8,40,72,104} carry x in {8,24,40,72,88,104};
    # rows at y in {24,88} carry x in {8,40,72,104} (the {24,88} columns are
    # already taken by the row bands above/below).
    xs_full = (8, 24, 40, 72, 88, 104)
    xs_thin = (8, 40, 72, 104)
    px: List[int] = []
    py: List[int] = []
    for y in (8, 24, 40, 72, 88, 104):
        row_xs = xs_full if y in (8, 40, 72, 104) else xs_thin
        px.extend(row_xs)
        py.extend([y] * len(row_xs))
    half.append(CuClass("16x16_U123", 16, 16, tuple(px), tuple(py)))
    return half


@dataclass(frozen=True)
class ComputeClass:
    """A merged group of canonical classes sharing one (w, h)."""

    width: int
    height: int
    class_indices: Tuple[int, ...]      # canonical class ids merged here
    xs: Tuple[int, ...]                 # concatenated CU x offsets
    ys: Tuple[int, ...]
    cu_flat_idx: Tuple[int, ...]        # canonical flat CU index of each CU

    @property
    def num_cus(self) -> int:
        return len(self.xs)

    @property
    def sb_cols(self) -> int:
        return self.width // SB

    @property
    def sb_rows(self) -> int:
        return self.height // SB

    @property
    def sbs_per_cu(self) -> int:
        return self.sb_cols * self.sb_rows


@dataclass(frozen=True)
class Layout:
    """Complete static geometry of one alignment mode ('full' or 'half')."""

    mode: str
    classes: Tuple[CuClass, ...]
    return_strides: Tuple[int, ...]     # canonical per-class CU offsets
    cus_per_ctu: int                    # 201 (full) / 284 (half)
    compute_classes: Tuple[ComputeClass, ...]
    # flat canonical per-CU tables, length == cus_per_ctu
    cu_class_id: np.ndarray             # int32 [nCU]
    cu_x: np.ndarray                    # int32 [nCU] CTU-relative
    cu_y: np.ndarray
    cu_w: np.ndarray
    cu_h: np.ndarray
    cu_log2w: np.ndarray
    cu_log2h: np.ndarray


def _build_layout(mode: str, classes: List[CuClass]) -> Layout:
    strides = []
    acc = 0
    for c in classes:
        strides.append(acc)
        acc += c.num_cus
    n_cu = acc

    cu_class_id = np.empty(n_cu, np.int32)
    cu_x = np.empty(n_cu, np.int32)
    cu_y = np.empty(n_cu, np.int32)
    cu_w = np.empty(n_cu, np.int32)
    cu_h = np.empty(n_cu, np.int32)
    for ci, c in enumerate(classes):
        s = strides[ci]
        for i in range(c.num_cus):
            cu_class_id[s + i] = ci
            cu_x[s + i] = c.xs[i]
            cu_y[s + i] = c.ys[i]
            cu_w[s + i] = c.width
            cu_h[s + i] = c.height

    # merge equal sizes, preserving first-appearance order
    merged: Dict[Tuple[int, int], List[int]] = {}
    for ci, c in enumerate(classes):
        merged.setdefault((c.width, c.height), []).append(ci)
    compute_classes = []
    for (w, h), cids in merged.items():
        xs: List[int] = []
        ys: List[int] = []
        flat: List[int] = []
        for ci in cids:
            c = classes[ci]
            xs.extend(c.xs)
            ys.extend(c.ys)
            flat.extend(range(strides[ci], strides[ci] + c.num_cus))
        compute_classes.append(
            ComputeClass(w, h, tuple(cids), tuple(xs), tuple(ys), tuple(flat))
        )

    return Layout(
        mode=mode,
        classes=tuple(classes),
        return_strides=tuple(strides),
        cus_per_ctu=n_cu,
        compute_classes=tuple(compute_classes),
        cu_class_id=cu_class_id,
        cu_x=cu_x,
        cu_y=cu_y,
        cu_w=cu_w,
        cu_h=cu_h,
        cu_log2w=np.log2(cu_w).astype(np.int32),
        cu_log2h=np.log2(cu_h).astype(np.int32),
    )


@functools.lru_cache(maxsize=None)
def layout(mode: str) -> Layout:
    """Static geometry for ``mode`` in {'full', 'half'}."""
    if mode == "full":
        return _build_layout("full", _aligned_classes())
    if mode == "half":
        return _build_layout("half", _half_aligned_classes())
    raise ValueError(f"unknown alignment mode {mode!r}")


@dataclass(frozen=True)
class FrameGrid:
    """CTU tiling of a frame."""

    width: int
    height: int
    ctu_cols: int
    ctu_rows: int

    @property
    def num_ctus(self) -> int:
        return self.ctu_cols * self.ctu_rows

    def ctu_origin(self) -> Tuple[np.ndarray, np.ndarray]:
        """Absolute (x, y) of every CTU, raster order -> int32 [nCtu]."""
        idx = np.arange(self.num_ctus, dtype=np.int32)
        return (idx % self.ctu_cols) * CTU_W, (idx // self.ctu_cols) * CTU_H


def frame_grid(width: int, height: int) -> FrameGrid:
    return FrameGrid(width, height, -(-width // CTU_W), -(-height // CTU_H))
