"""Exact integer helpers shared by the batched ops.

Shifts on signed integer tensors in PyTorch are arithmetic, matching the C
semantics of the VTM math.  Every helper keeps its input dtype (int32 in the
engine): Python-int operands never widen a tensor.
"""

from __future__ import annotations

import torch


def round_shift(v: torch.Tensor, shift: int) -> torch.Tensor:
    """VTM MV rounding: (v + (1<<(s-1)) - (v>=0)) >> s   (aux_functions.cl:38-47)."""
    offset = 1 << (shift - 1)
    return (v + offset - (v >= 0).to(v.dtype)) >> shift


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1, exact (bit-cascade, no floats)."""
    x = x.to(torch.int32)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        r = r + hit.to(torch.int32) * s
        x = torch.where(hit, x >> s, x)
    return r


def clamp(v, lo, hi):
    """min(max(v, lo), hi) with scalar or tensor bounds (dtype of ``v``)."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        lo = torch.as_tensor(lo, dtype=v.dtype, device=v.device)
        hi = torch.as_tensor(hi, dtype=v.dtype, device=v.device)
        return torch.minimum(torch.maximum(v, lo), hi)
    return torch.clamp(v, lo, hi)
