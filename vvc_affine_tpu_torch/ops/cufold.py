"""Per-CU SATD and normal equations from K2's block sums on a card
(csrc/cufold.cu).

The engine's ``affine_plane._fold_cu`` folds K2's per-block SATD and
moments into each CU's SATD sum and normal equations (M, rhs).  On CPU
tensors it runs its plain version (``affine_plane._fold_cu_plain``, a loop
over the CU classes); on CUDA tensors it calls ``fold_cu`` here, which
launches the hand-written kernel once: one thread per (CTU, lane), a lane
being one block column of one CU, reading the static lane table
``planes.fold_lane_table`` (``PlaneTables.fold_lanes``) and the block
table ``planes.bin_slot_table`` (``PlaneTables.mv_slots``).  Nothing falls
back to the plain version.
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.planes import LANE_ROWS, NB, SLOT_ROWS


def fold_cu(satd_b, moms_b, within, lanes, slots, n_cp: int, refine: bool):
    """(satd, M, rhs) from CUDA inputs: satd_b int32 [nCtu, nBins, NB, NB]
    and, with ``refine``, moms_b int32 [nCtu, nBins, 5, NB, NB] (K2's
    outputs; else None); within bool [nCtu, nCU]; lanes int32
    [len(LANE_ROWS), n_lanes] (``planes.fold_lane_table`` of the mode);
    slots int32 [6, nBins, NB, NB] (``planes.bin_slot_table``); ``n_cp`` 2
    or 3.  satd is int64 [nCtu, nCU]; with ``refine`` M int64 [nCtu, nCU,
    P, P] and rhs int64 [nCtu, nCU, P] (P = 2 n_cp), else None, None.  Zero
    for CUs out of the frame."""
    out, run = bind_fold_cu(satd_b, moms_b, within, lanes, slots, n_cp,
                            refine)
    run()
    return out


def bind_fold_cu(satd_b, moms_b, within, lanes, slots, n_cp: int,
                 refine: bool):
    """The kernel bound to CUDA inputs (``fold_cu``'s contract): returns
    the outputs (satd, M, rhs) and a callable that launches the kernel into
    them."""
    if n_cp not in (2, 3):
        raise ValueError(f"n_cp must be 2 or 3, got {n_cp}")
    # the tables' shapes give the sizes
    n_ctu, n_cus = within.shape if within.dim() == 2 else (0, 0)
    n_bins = slots.shape[1] if slots.dim() == 4 else 0
    n_lanes = lanes.shape[1] if lanes.dim() == 2 else 0
    kernels.check(within, torch.bool, (n_ctu, n_cus), "within")
    dev = within.device
    kernels.check(satd_b, torch.int32, (n_ctu, n_bins, NB, NB), "satd_b",
                  dev)
    if refine:
        kernels.check(moms_b, torch.int32, (n_ctu, n_bins, 5, NB, NB),
                      "moms_b", dev)
    elif moms_b is not None:
        raise ValueError("moms_b: expected None without refine")
    kernels.check(lanes, torch.int32, (len(LANE_ROWS), n_lanes), "lanes",
                  dev)
    if n_lanes % 32:
        raise ValueError(f"lanes: {n_lanes} lanes, not a multiple of 32")
    kernels.check(slots, torch.int32, (len(SLOT_ROWS), n_bins, NB, NB),
                  "slots", dev)
    Pn = 2 * n_cp
    satd = torch.empty((n_ctu, n_cus), dtype=torch.int64, device=dev)
    M = rhs = None
    if refine:
        M = torch.empty((n_ctu, n_cus, Pn, Pn), dtype=torch.int64, device=dev)
        rhs = torch.empty((n_ctu, n_cus, Pn), dtype=torch.int64, device=dev)
    return (satd, M, rhs), kernels.bind(
        "cufold", dev, satd, M, rhs, satd_b, moms_b, within, lanes, slots,
        n_ctu, n_cus, n_bins, n_lanes, n_cp, int(refine))
