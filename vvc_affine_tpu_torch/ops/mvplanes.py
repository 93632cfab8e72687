"""Per-bin motion planes from canonical CPMVs on a card (csrc/mvplanes.cu).

The engine's ``affine_plane._mv_planes`` turns each CU's CPMVs into the
dy, dx, fx, fy int32 [nCtu, nBins, NB, NB] planes that K1 reads.  On CPU
tensors it runs its plain version (``affine_plane._mv_planes_plain``, a
loop over the CU classes); on CUDA tensors it calls ``mv_planes`` here,
which launches the hand-written kernel once: one thread per (CTU, bin,
block), reading the block's CU from the static ``planes.bin_slot_table``
(``PlaneTables.mv_slots``).  Nothing falls back to the plain version.
"""

from __future__ import annotations

import torch

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.planes import NB, SLOT_ROWS

PLANES = ("dy", "dx", "fx", "fy")     # the outputs, in order


def mv_planes(cpmvs, abs_x, abs_y, within, slots, n_cp: int, frame_w: int,
              frame_h: int):
    """(dy, dx, fx, fy), each int32 [nCtu, nBins, NB, NB], from CUDA inputs:
    cpmvs int32 [nCtu, nCU, 3, 2] (canonical class order); abs_x, abs_y
    int32 and within bool [nCtu, nCU]; slots int32 [6, nBins, NB, NB]
    (``planes.bin_slot_table`` of the mode); ``n_cp`` 2 or 3.  Blocks that
    no CU covers and blocks of out-of-frame CUs are zero."""
    planes, run = bind_mv_planes(cpmvs, abs_x, abs_y, within, slots, n_cp,
                                 frame_w, frame_h)
    run()
    return planes


def bind_mv_planes(cpmvs, abs_x, abs_y, within, slots, n_cp: int,
                   frame_w: int, frame_h: int):
    """The kernel bound to CUDA inputs (``mv_planes``' contract): returns
    the four output planes (views of one buffer) and a callable that
    launches the kernel into them."""
    if n_cp not in (2, 3):
        raise ValueError(f"n_cp must be 2 or 3, got {n_cp}")
    # the tables' shapes give the sizes
    n_ctu, n_cus = abs_x.shape if abs_x.dim() == 2 else (0, 0)
    n_bins = slots.shape[1] if slots.dim() == 4 else 0
    kernels.check(abs_x, torch.int32, (n_ctu, n_cus), "abs_x")
    dev = abs_x.device
    kernels.check(cpmvs, torch.int32, (n_ctu, n_cus, 3, 2), "cpmvs", dev)
    kernels.check(abs_y, torch.int32, (n_ctu, n_cus), "abs_y", dev)
    kernels.check(within, torch.bool, (n_ctu, n_cus), "within", dev)
    kernels.check(slots, torch.int32, (len(SLOT_ROWS), n_bins, NB, NB),
                  "slots", dev)
    out = torch.empty((4, n_ctu, n_bins, NB, NB), dtype=torch.int32,
                      device=dev)
    return out.unbind(0), kernels.bind(
        "mvplanes", dev, out, cpmvs, abs_x, abs_y, within, slots, n_ctu,
        n_cus, n_bins, n_cp, frame_w, frame_h)
