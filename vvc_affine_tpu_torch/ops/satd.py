"""Batched 4x4 Hadamard SATD with VTM mean scaling.

Behavioural spec: RdCost::xCalcHADs4x4 as transcribed in
aux_functions.cl:1940-2043.  All arithmetic int32-exact.
"""

from __future__ import annotations


def satd_4x4(orig, pred, sample_axis: int = -1):
    """Row-major 4x4 SATD, int32.

    orig/pred carry the 16 samples of each block along ``sample_axis``
    (default last).  Returns SATD with ``sample_axis`` removed.
    """
    d = orig - pred
    ax = sample_axis if sample_axis >= 0 else d.ndim + sample_axis

    def col(i):
        return d.select(ax, i)

    m = [None] * 16
    for k in range(4):
        m[k] = col(k) + col(12 + k)
        m[4 + k] = col(4 + k) + col(8 + k)
        m[8 + k] = col(4 + k) - col(8 + k)
        m[12 + k] = col(k) - col(12 + k)
    e = [None] * 16
    for k in range(4):
        e[k] = m[k] + m[4 + k]
        e[4 + k] = m[8 + k] + m[12 + k]
        e[8 + k] = m[k] - m[4 + k]
        e[12 + k] = m[12 + k] - m[8 + k]
    for base in range(0, 16, 4):
        m[base + 0] = e[base + 0] + e[base + 3]
        m[base + 1] = e[base + 1] + e[base + 2]
        m[base + 2] = e[base + 1] - e[base + 2]
        m[base + 3] = e[base + 0] - e[base + 3]
    for base in range(0, 16, 4):
        e[base + 0] = m[base + 0] + m[base + 1]
        e[base + 1] = m[base + 0] - m[base + 1]
        e[base + 2] = m[base + 2] + m[base + 3]
        e[base + 3] = m[base + 3] - m[base + 2]

    absd = [v.abs() for v in e]
    satd = absd[0]
    for k in range(1, 16):
        satd = satd + absd[k]
    # JVET_R0164 mean-scaled SATD
    satd = satd - absd[0] + (absd[0] >> 2)
    return (satd + 1) >> 1
