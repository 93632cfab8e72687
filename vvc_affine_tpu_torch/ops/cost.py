"""Batched rate estimation and RD cost.

Behavioural spec: aux_functions.cl:2116-2221 (xGetExpGolombNumberOfBits,
getBitsOfVectorWithPredictor, calc_affine_bits, getCost).  The reference uses
a zero CPMV predictor for both 2CP (affine.cl:434, predCpmvs stays zero) and
3CP (affine.cl:432, explicit zeroCpmvs); with a zero predictor the RT/LB
predictors collapse to LT.
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch.ops.mv import change_precision_to_quarter
from vvc_affine_tpu_torch.utils.bitmath import floor_log2


def exp_golomb_bits(value):
    """int32 [...] -> bit count [...]; exact for |value| < 2^28."""
    t = torch.where(value <= 0, ((-value) << 1) + 1, value << 1)
    length = torch.ones_like(t)
    for _ in range(3):  # |MV diff| <= 2^17 needs 2 folds; 3 covers 2^24
        big = t > C.MAX_CU_SIZE
        length = length + big.to(t.dtype) * (C.MAX_CU_DEPTH << 1)
        t = torch.where(big, t >> C.MAX_CU_DEPTH, t)
    return length + (floor_log2(t) << 1)


def affine_bits_zero_pred(cpmvs, n_cp: int):
    """calc_affine_bits with the zero predictor (aux:2140-2188).

    cpmvs: int32 [..., 3, 2] -> bits int32 [...].
    """
    q = change_precision_to_quarter(cpmvs)  # [..., 3, 2]
    lt = q[..., 0, :]
    bits = exp_golomb_bits(lt[..., 0]) + exp_golomb_bits(lt[..., 1])
    rt = q[..., 1, :]
    bits = bits + exp_golomb_bits(rt[..., 0] - lt[..., 0])
    bits = bits + exp_golomb_bits(rt[..., 1] - lt[..., 1])
    if n_cp == 3:
        lb = q[..., 2, :]
        bits = bits + exp_golomb_bits(lb[..., 0] - lt[..., 0])
        bits = bits + exp_golomb_bits(lb[..., 1] - lt[..., 1])
    return bits


def rd_cost(satd, bits, lam: torch.Tensor):
    """satd int64 [...] + floor(float32(lambda) * float32(bits + ruiBits)).

    ``lam`` is a float32 tensor (0-d): a float64 lambda would compute the
    product in double precision and change costs.
    """
    if lam.dtype != torch.float32:
        raise TypeError(f"lambda must be a float32 tensor, got {lam.dtype}")
    rate = torch.floor(
        lam * (bits + C.RUI_BITS).to(torch.float32)).to(torch.int64)
    return satd.to(torch.int64) + rate
