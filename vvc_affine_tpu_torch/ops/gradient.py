"""Per-CU 3x3 Sobel gradient with border replication.

Port of the JAX package's ``ops/gradient.py``.  Behavioural spec:
affine.cl:477-540 — the reference computes the Sobel over the whole CTU
plane (zeroing CTU borders) and then refills every CU's border
rows/cols/corners from the adjacent interior values, which per CU is the
Sobel of the CU's own prediction on its interior, edge-padded outward
(rows, then columns, then corners).
"""

from __future__ import annotations

import torch


def _pad_edge(g):
    """Replicate the outermost rows, then columns, of [..., h, w] (int32
    stays int32: concatenation of edge slices, no float padding)."""
    g = torch.cat([g[..., :1, :], g, g[..., -1:, :]], dim=-2)
    return torch.cat([g[..., :1], g, g[..., -1:]], dim=-1)


def sobel_cu(pred):
    """pred: int32 [..., h, w] (one plane per CU) -> (gx, gy) int32 [..., h, w]."""
    p = pred
    gx_i = (
        p[..., :-2, 2:] - p[..., :-2, :-2]
        + 2 * p[..., 1:-1, 2:] - 2 * p[..., 1:-1, :-2]
        + p[..., 2:, 2:] - p[..., 2:, :-2]
    )
    gy_i = (
        p[..., 2:, :-2] - p[..., :-2, :-2]
        + 2 * p[..., 2:, 1:-1] - 2 * p[..., :-2, 1:-1]
        + p[..., 2:, 2:] - p[..., :-2, 2:]
    )
    return _pad_edge(gx_i), _pad_edge(gy_i)
