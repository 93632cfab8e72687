"""Decision-log CSV writer and timing report.

Behavioural spec: reportAffineResultsMaster_new
(main_aux_functions.h:387-525) — one CSV per (pred type, CU size string),
header ``POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y``, rows
appended per (poc, refIdx) in class order; half-aligned size groups sharing a
size string share a file.  removeOldTraces (main_aux_functions.h:1547-1585)
deletes stale logs before a run.  The bytes written are the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from vvc_affine_tpu_torch import geometry as G

PRED_NAMES = ("FULL_2CPs", "FULL_3CPs", "HALF_2CPs", "HALF_3CPs")
PRED_MODES = ("full", "full", "half", "half")

_HEADER = "POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y\n"


def log_paths(prefix: str, pred: int):
    """All decision-log paths of one pred type (dedup preserves order)."""
    lay = G.layout(PRED_MODES[pred])
    seen = []
    for c in lay.classes:
        p = f"{prefix}_{PRED_NAMES[pred]}_{c.size_str}.csv"
        if p not in seen:
            seen.append(p)
    return seen


def remove_old_traces(prefix: str) -> None:
    for pred in range(4):
        for p in log_paths(prefix, pred):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def write_headers(prefix: str, pred: int) -> None:
    for p in log_paths(prefix, pred):
        with open(p, "w") as f:
            f.write(_HEADER)


def report_results(
    prefix: Optional[str],
    pred: int,
    frame_w: int,
    costs: np.ndarray,      # int64 [nCtu, nCU] canonical order
    cpmvs: np.ndarray,      # int32 [nCtu, nCU, 3, 2]
    poc: int,
    ref: int,
    to_terminal: bool = False,
) -> None:
    """Append one (poc, refIdx, pred) result block to the decision logs."""
    if prefix is None and not to_terminal:
        return
    lay = G.layout(PRED_MODES[pred])
    n_ctus = costs.shape[0]
    ctu_cols = -(-frame_w // 128)

    if prefix is not None and poc == 1 and ref == 0:
        write_headers(prefix, pred)

    handles: Dict[str, object] = {}
    try:
        for ci, cls in enumerate(lay.classes):
            stride = lay.return_strides[ci]
            path = f"{prefix}_{PRED_NAMES[pred]}_{cls.size_str}.csv" if prefix else None
            fh = None
            if path is not None:
                if path not in handles:
                    handles[path] = open(path, "a")
                fh = handles[path]
            # vectorised row block: meta (POC,List,Ref,CTU,idx,X,Y), cost,
            # six CPMV components per row, CTU-major, CU raster within
            nc = cls.num_cus
            ctu_ids = np.arange(n_ctus, dtype=np.int32)
            off_x = (ctu_ids % ctu_cols) * 128
            off_y = (ctu_ids // ctu_cols) * 128
            meta = np.empty((n_ctus, nc, 7), np.int32)
            meta[..., 0] = poc
            meta[..., 1] = 0
            meta[..., 2] = ref
            meta[..., 3] = ctu_ids[:, None]
            meta[..., 4] = np.arange(nc, dtype=np.int32)[None, :]
            meta[..., 5] = off_x[:, None] + np.asarray(cls.xs, np.int32)[None, :]
            meta[..., 6] = off_y[:, None] + np.asarray(cls.ys, np.int32)[None, :]
            cost_blk = np.ascontiguousarray(
                costs[:, stride:stride + nc], np.int64)
            cpmv_blk = np.ascontiguousarray(
                cpmvs[:, stride:stride + nc].reshape(n_ctus, nc, 6), np.int32)

            lines = []
            for ctu in range(n_ctus):
                for cu in range(nc):
                    m = meta[ctu, cu]
                    v = cpmv_blk[ctu, cu]
                    lines.append(
                        f"{m[0]},{m[1]},{m[2]},{m[3]},{m[4]},{m[5]},{m[6]},"
                        f"{cost_blk[ctu, cu]},"
                        f"{v[0]},{v[1]},{v[2]},{v[3]},{v[4]},{v[5]}\n"
                    )
            block = "".join(lines)
            if fh is not None:
                fh.write(block)
            if to_terminal:
                print(block, end="")
    finally:
        for fh in handles.values():
            fh.close()


class Timing:
    """Per-pred execution-time accumulator (ns) + wall-clock stamps.

    Mirrors kernelExecutionTime[4] / reportTimingResults
    (main_aux_functions.h:1416-1446) and print_timestamp (:59-68).  Times
    come from the pipeline: CUDA events on the card, the host clock on the
    CPU.  ``events`` keeps every timed dispatch as (label, seconds).
    """

    def __init__(self) -> None:
        self.exec_ns = [0.0, 0.0, 0.0, 0.0]
        self.pair_ns = {0: 0.0, 2: 0.0}   # fused 2CP+3CP dispatches
        self.events: List[Tuple[str, float]] = []
        self.t0 = time.time()

    def stamp(self, msg: str) -> None:
        t = time.time()
        print(f"{msg},{int(t)}.{int((t % 1) * 1e6):06d},")

    def add(self, pred: int, seconds: float, label: str = "") -> None:
        self.exec_ns[pred] += seconds * 1e9
        self.events.append((label, seconds))

    def add_pair(self, base_pred: int, seconds: float,
                 label: str = "") -> None:
        """Fused-pair exec time (pipeline fused mode): one dispatch runs
        both nCP stages, so the split per pred type does not exist; the
        pair total is reported on its own line."""
        self.pair_ns[base_pred] += seconds * 1e9
        self.events.append((label, seconds))

    def report(self, n_frames: int) -> None:
        print("=-" * 23)
        print("TIMING RESULTS (nanoseconds)")
        names = ("FULL_2CP", "FULL_3CP", "HALF_2CP", "HALF_3CP")
        for pred, name in enumerate(names):
            if self.pair_ns.get(pred & ~1):
                if pred % 2 == 0:
                    print(f"{name}+{names[pred + 1]}_EXEC,"
                          f"{self.pair_ns[pred]:f}")
                continue
            print(f"{name}_EXEC,{self.exec_ns[pred]:f}")
        total = sum(self.exec_ns) + sum(self.pair_ns.values())
        print(f"TOTAL_EXEC_TIME({n_frames}x),{total:f}")
        print(f"OVERALL({n_frames}x),{(time.time() - self.t0) * 1e9:f}")
        for label, seconds in self.events:
            print(f"{label},{seconds * 1e9:f}")
        print("=-" * 23)
