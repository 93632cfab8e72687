"""Reference-picture list: 4-slot circular buffer with long-term retention.

Behavioural spec: the device-buffer shuffle of main.cpp:578-707 (and its host
model testReferences, main_aux_functions.h:1499-1545), which mirrors the VTM
low-delay reference list: every new POC shifts refs down one slot; once the
list is full, slots holding a long-term reference (POC % 8 == 0, provided the
slots below it are also long-term) are only displaced by another long-term
candidate.

The reference engine shuffles whole frame buffers between cl_mem objects; on
the device the frames live as tensors, so this manager tracks POC labels and
hands out the label list — the pipeline resolves labels to arrays (zero-copy
reordering instead of the reference's device-to-device copies).
"""

from __future__ import annotations

from typing import List

from vvc_affine_tpu_torch import constants as C


class ReferenceBuffer:
    """Tracks which POC occupies each of the MAX_REFS slots."""

    def __init__(self) -> None:
        self.labels: List[int] = [-1] * C.MAX_REFS
        self.is_lt: List[int] = [0] * C.MAX_REFS

    def push(self, poc: int) -> None:
        """Register reconstructed frame (poc-1) before encoding POC ``poc``."""
        labels, is_lt = self.labels, self.is_lt
        if poc < 5:  # list not yet full: shift everything down
            temp_a = labels[0]
            labels[0] = poc - 1
            temp_b = labels[1]
            labels[1] = temp_a
            temp_a, labels[2] = labels[2], temp_b
            labels[3] = temp_a
            is_lt[3] = 1 if labels[3] % 8 == 0 else 0
        else:
            temp_a = labels[0]
            labels[0] = poc - 1
            update = (
                is_lt[1] == 0
                or (temp_a % 8 == 0 and temp_a != labels[0])
            )
            if update:
                temp_b = labels[1]
                labels[1] = temp_a
                update = (
                    is_lt[2] == 0
                    or (temp_b % 8 == 0 and temp_b != labels[1])
                )
                if update:
                    temp_a = labels[2]
                    labels[2] = temp_b
                    update = (
                        is_lt[3] == 0
                        or (temp_a % 8 == 0 and temp_a != labels[3])
                    )
                    if update:
                        labels[3] = temp_a
            is_lt[3] = 1 if labels[3] % 8 == 0 else 0
            is_lt[2] = 1 if (labels[2] % 8 == 0 and is_lt[3]) else 0
            is_lt[1] = 1 if (labels[1] % 8 == 0 and is_lt[2]) else 0

    def ref_list(self, poc: int) -> List[int]:
        """POC labels of the active references for encoding ``poc``."""
        return self.labels[: min(C.MAX_REFS, poc)]
