"""VTM-12.0 constants and rate-control models used by Affine ME.

Every value is inherited from the VVC reference software (VTM-12.0) by way of
the reference engine (see the reference's constants.cl:11-61 and
constants.h:71-103 for the same inheritance).  The luma
interpolation filter bank and the lambda tables are standard-defined data, not
code.
"""

from __future__ import annotations

import numpy as np

# --- VTM core constants (constants.cl:12-37) -------------------------------
MAX_CU_DEPTH = 7
MV_FRACTIONAL_BITS_INTERNAL = 4
MAX_CU_WIDTH = 128
MAX_CU_HEIGHT = 128
IF_FILTER_PREC = 6
IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)
CLP_RNG_MAX = 1023
CLP_RNG_MIN = 0
NTAPS_LUMA = 8
MV_PRECISION_INTERNAL = 2 + MV_FRACTIONAL_BITS_INTERNAL  # = 6
MAX_CU_SIZE = 1 << MAX_CU_DEPTH  # = 128

# AMVR precisions (constants.cl:26-28)
AFFINE_MV_PRECISION_QUARTER = 4
AFFINE_MV_PRECISION_SIXTEENTH = 1
AFFINE_MV_PRECISION_INT = 2

SUBBLOCK_SIZE = 4
PROF_PADDING = 1

# MV clamp range (constants.cl:35-37)
MV_BITS = 18
MV_MAX = (1 << (MV_BITS - 1)) - 1
MV_MIN = -(1 << (MV_BITS - 1))

MAX_LONG = np.int64(1) << 62

CTU_WIDTH = 128
CTU_HEIGHT = 128

# Base affine-mode bitrate (ruiBits) — 2 for low-delay-P (constants.cl:441,
# affine.cl:442-446), 4 otherwise.
LOW_DELAY_P = True
RUI_BITS = 2 if LOW_DELAY_P else 4

# Number of reference pictures kept by the engine (constants.h:71).
MAX_REFS = 4

# --- VTM 1/16-pel luma interpolation filter for 4x4 affine sub-blocks ------
# (constants.cl:40-58; VTM InterpolationFilter::m_lumaFilter4x4)
LUMA_FILTER_4x4 = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [0, 1, -3, 63, 4, -2, 1, 0],
        [0, 1, -5, 62, 8, -3, 1, 0],
        [0, 2, -8, 60, 13, -4, 1, 0],
        [0, 3, -10, 58, 17, -5, 1, 0],
        [0, 3, -11, 52, 26, -8, 2, 0],
        [0, 2, -9, 47, 31, -10, 3, 0],
        [0, 3, -11, 45, 34, -10, 3, 0],
        [0, 3, -11, 40, 40, -11, 3, 0],
        [0, 3, -10, 34, 45, -11, 3, 0],
        [0, 3, -10, 31, 47, -9, 2, 0],
        [0, 2, -8, 26, 52, -11, 3, 0],
        [0, 1, -5, 17, 58, -10, 3, 0],
        [0, 1, -4, 13, 60, -8, 2, 0],
        [0, 1, -3, 8, 62, -5, 1, 0],
        [0, 1, -2, 4, 63, -3, 1, 0],
    ],
    dtype=np.int32,
)

# --- Rate-control lambda model (constants.h:82-103) -------------------------
# Low-delay lambdas for the four canonical QPs.
LAMBDAS_BY_QP_INDEX = np.array(
    [17.583905, 39.474532, 78.949063, 140.671239], dtype=np.float32
)

# Lambdas indexed by the *effective* per-frame QP (constants.h:94-103).
FULL_LAMBDAS = np.array(
    [
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
    ],
    dtype=np.float32,
)

# GOP-8 low-delay per-POC QP offsets (main_aux_functions.h:1483 pocOffset).
POC_QP_OFFSET = (1, 5, 4, 5, 4, 5, 4, 5)


def compute_delta_qp(input_qp: int, poc: int) -> int:
    """Effective QP for a POC under the GOP-8 low-delay schedule.

    Mirrors computeDeltaQp() (main_aux_functions.h:1482-1497): adds the
    per-POC offset plus a clipped linear model (scale .259, offset -6.5).
    """
    model_scale = 0.0 if poc % 8 == 0 else 0.259
    model_offset = 0.0 if poc % 8 == 0 else -6.5
    qp = input_qp + POC_QP_OFFSET[poc % 8]
    d_qp_offset = qp * model_scale + model_offset + 0.5
    qp_offset = int(np.floor(min(3.0, max(0.0, d_qp_offset))))
    return qp + qp_offset


def lambda_for(input_qp: int, poc: int) -> float:
    """Motion lambda for a frame: fullLambdas[computeDeltaQp(qp, poc)]."""
    return float(FULL_LAMBDAS[compute_delta_qp(input_qp, poc)])


def num_ctus(frame_width: int, frame_height: int) -> int:
    """CTU count of a frame.

    Computed (not table-driven like constants.h:73-79); reproduces the table:
    3840x2160 -> 510, 1920x1080 -> 135, 1280x720 -> 60, 832x480 -> 28,
    416x240 -> 8.
    """
    cols = -(-frame_width // CTU_WIDTH)
    rows = -(-frame_height // CTU_HEIGHT)
    return cols * rows


def ctus_per_row(frame_width: int) -> int:
    return -(-frame_width // CTU_WIDTH)
