"""The CU geometry of VTM-12.0's affine ME, frozen for the benchmark.

The reference encoder (iagostorch/VVC-Affine-GPU, ``constants.cl``
WIDTH_LIST / HA_WIDTH_LIST) searches a fixed set of CU size classes inside
every 128x128 CTU: 12 aligned classes (each tiles the CTU) and 24
half-aligned groups (offset by half a CU, as VVC split trees place them).
The order of the classes, and of the CUs inside a class (raster, y-major),
is the order of the decisions in every result.  The benchmark keeps its own
copy so that its reference and its roofline counts read nothing of the
program under test.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

CTU = 128
SB = 4  # affine sub-block size


@dataclass(frozen=True)
class CuClass:
    name: str
    width: int
    height: int
    xs: Tuple[int, ...]   # CTU-relative CU corners, raster order
    ys: Tuple[int, ...]

    @property
    def num_cus(self) -> int:
        return len(self.xs)


def _grid(name, w, h, xs, ys) -> CuClass:
    px = tuple(x for _ in ys for x in xs)
    py = tuple(y for y in ys for _ in xs)
    return CuClass(name, w, h, px, py)


_ALIGNED = ((128, 128), (128, 64), (64, 128), (64, 64), (64, 32), (32, 64),
            (32, 32), (64, 16), (16, 64), (32, 16), (16, 32), (16, 16))

_R16 = tuple(range(0, 128, 16))
_Q8 = (8, 40, 72, 104)
_HALF = (
    ("64x32", 64, 32, (0, 64), (16, 80)),
    ("32x64", 32, 64, (16, 80), (0, 64)),
    ("64x16_G1", 64, 16, (0, 64), _Q8),
    ("64x16_G2", 64, 16, (0, 64), (24, 88)),
    ("16x64_G1", 16, 64, _Q8, (0, 64)),
    ("16x64_G2", 16, 64, (24, 88), (0, 64)),
    ("32x32_G1", 32, 32, (16, 80), (0, 32, 64, 96)),
    ("32x32_G2", 32, 32, (0, 32, 64, 96), (16, 80)),
    ("32x16_G1", 32, 16, (0, 32, 64, 96), _Q8),
    ("32x16_G2", 32, 16, (0, 32, 64, 96), (24, 88)),
    ("32x16_G3", 32, 16, (16, 80), _R16),
    ("16x32_G1", 16, 32, _Q8, (0, 32, 64, 96)),
    ("16x32_G2", 16, 32, (24, 88), (0, 32, 64, 96)),
    ("16x32_G3", 16, 32, _R16, (16, 80)),
    ("16x16_G1", 16, 16, _R16, _Q8),
    ("16x16_G2", 16, 16, _Q8, _R16),
    ("16x16_G3", 16, 16, _R16, (24, 88)),
    ("16x16_G4", 16, 16, (24, 88), _R16),
    ("32x32_U1", 32, 32, (16, 80), (16, 80)),
    ("32x16_U1", 32, 16, (16, 80), _Q8),
    ("32x16_U2", 32, 16, (16, 80), (24, 88)),
    ("16x32_U1", 16, 32, _Q8, (16, 80)),
    ("16x32_U2", 16, 32, (24, 88), (16, 80)),
)


def _u123() -> CuClass:
    """16x16_U123: rows at y in {8,40,72,104} hold six CUs, rows at y in
    {24,88} four (their middle columns belong to the bands beside them)."""
    px, py = [], []
    for y in (8, 24, 40, 72, 88, 104):
        row = (8, 24, 40, 72, 88, 104) if y in _Q8 else _Q8
        px.extend(row)
        py.extend([y] * len(row))
    return CuClass("16x16_U123", 16, 16, tuple(px), tuple(py))


@functools.lru_cache(maxsize=None)
def classes(mode: str) -> Tuple[CuClass, ...]:
    """The size classes of ``mode`` ('full': aligned, 'half':
    half-aligned) in the order of the results."""
    if mode == "full":
        return tuple(_grid(f"{w}x{h}", w, h, tuple(range(0, CTU, w)),
                           tuple(range(0, CTU, h))) for w, h in _ALIGNED)
    if mode == "half":
        return tuple(_grid(*c) for c in _HALF) + (_u123(),)
    raise ValueError(f"unknown mode {mode!r}")


def cus_per_ctu(mode: str) -> int:
    return sum(c.num_cus for c in classes(mode))


def ctu_grid(frame_w: int, frame_h: int) -> Tuple[int, int]:
    """(columns, rows) of CTUs covering the frame."""
    return -(-frame_w // CTU), -(-frame_h // CTU)


def cus(mode: str, frame_w: int, frame_h: int):
    """Every CU of every CTU, in result order: a list of (ctu, index in
    the CTU, width, height, absolute x, absolute y, fully in frame)."""
    cols, rows = ctu_grid(frame_w, frame_h)
    out = []
    for ctu in range(cols * rows):
        ox, oy = (ctu % cols) * CTU, (ctu // cols) * CTU
        k = 0
        for c in classes(mode):
            for x, y in zip(c.xs, c.ys):
                ax, ay = ox + x, oy + y
                out.append((ctu, k, c.width, c.height, ax, ay,
                            ax + c.width <= frame_w and ay + c.height <= frame_h))
                k += 1
    return out
