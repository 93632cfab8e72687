"""Decision-log CSV writer, timing report, device trace and memory report.

Behavioural spec: reportAffineResultsMaster_new
(main_aux_functions.h:387-525) — one CSV per (pred type, CU size string),
header ``POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y``, rows
appended per (poc, refIdx) in class order; half-aligned size groups sharing a
size string share a file.  removeOldTraces (main_aux_functions.h:1547-1585)
deletes stale logs before a run.  The bytes written are the JAX package's;
the rows go through the native writer (``native/``) unless they are also
printed.
"""

from __future__ import annotations

import csv
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vvc_affine_tpu_torch import geometry as G
from vvc_affine_tpu_torch import native
from vvc_affine_tpu_torch import planes as P

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


def format_rows(meta: np.ndarray, cost: np.ndarray, cpmv: np.ndarray) -> str:
    """The plain decision-log writer: rows as text, one per entry of meta
    int32 [n, 7], cost int64 [n] and cpmv int32 [n, 6] (the bytes
    ``native.append_decision_rows`` writes)."""
    return "".join(
        f"{m[0]},{m[1]},{m[2]},{m[3]},{m[4]},{m[5]},{m[6]},{c},"
        f"{v[0]},{v[1]},{v[2]},{v[3]},{v[4]},{v[5]}\n"
        for m, c, v in zip(meta, cost, cpmv))


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
    """Append one (poc, refIdx, pred) result block to the decision logs.

    The rows go through the native writer (``native.append_decision_rows``),
    or through ``format_rows`` when they are printed too
    (``to_terminal``), as the JAX package does.
    """
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
            meta = meta.reshape(-1, 7)
            cost_blk = np.ascontiguousarray(
                costs[:, stride:stride + nc], np.int64).reshape(-1)
            cpmv_blk = np.ascontiguousarray(
                cpmvs[:, stride:stride + nc], np.int32).reshape(-1, 6)

            if not to_terminal:
                native.append_decision_rows(path, meta, cost_blk, cpmv_blk)
                continue
            block = format_rows(meta, cost_blk, cpmv_blk)
            if path is not None:
                if path not in handles:
                    handles[path] = open(path, "a")
                handles[path].write(block)
            print(block, end="")
    finally:
        for fh in handles.values():
            fh.close()


class DeviceTraceSampler:
    """In-process ~1 ms device-memory activity sampler.

    The JAX package's trace CSV (``t_epoch,bytes_in_use,peak_bytes_in_use``,
    one row per period), so ``tools/energy_report.py`` joins it with the run
    log unchanged.  It samples the run's own device: the caching
    allocator's ``allocated_bytes.all.current`` and ``.peak`` on a CUDA
    device, zeros on the CPU (which has no such counters).
    """

    HEADER = ("t_epoch", "bytes_in_use", "peak_bytes_in_use")
    PERIOD_S = 1e-3

    def __init__(self, out_path: str, device: torch.device) -> None:
        self.out_path = out_path
        self.device = torch.device(device)
        self.rows: list = []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        cuda = self.device.type == "cuda"
        while not self._stop.is_set():
            t = time.time()
            if cuda:
                stats = torch.cuda.memory_stats(self.device)
                self.rows.append((t, stats.get("allocated_bytes.all.current", 0),
                                  stats.get("allocated_bytes.all.peak", 0)))
            else:
                self.rows.append((t, 0, 0))
            time.sleep(self.PERIOD_S)

    def start(self) -> None:
        self._th.start()

    def stop(self) -> None:
        self._stop.set()
        self._th.join(timeout=2)
        with open(self.out_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.HEADER)
            w.writerows(self.rows)
        print(f"device trace: {len(self.rows)} samples -> {self.out_path}")


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


def memory_report(frame_w: int, frame_h: int, device) -> str:
    """Per-stage device-buffer footprint table of the port's own buffers.

    Analogue of accessMemoryUsage/reportMemoryUsage
    (main_aux_functions.h:148-234, 1448-1471), which queries
    clGetMemObjectInfo for every kernel argument.  The sizes are static
    functions of the frame geometry.  Lines for buffers that the JAX
    package's report also lists carry its text and numbers (the frame
    plane, the displacement/phase planes, the int16 pred planes, the per-CU
    outputs and the int64 equation systems); its TPU-only buffers (refpad,
    per-CTU tiles, lane-expanded tap planes) have no line.  The two device
    lines read the caching allocator of ``device`` (n/a on the CPU).
    """
    grid = G.frame_grid(frame_w, frame_h)
    n = grid.num_ctus
    lines = [f"MEMORY USAGE (bytes), frame {frame_w}x{frame_h}, {n} CTUs"]
    lines.append(f"ref/orig plane (int32): {frame_w * frame_h * 4}")
    lines.append(f"per-CTU ref/orig planes (int32): {2 * n * 128 * 128 * 4}")
    for mode in ("full", "half"):
        lay = G.layout(mode)
        nb = len(P.bin_layout(mode)[0])
        lines.append(
            f"[{mode}] displacement/phase planes dy,dx,fx,fy (int32): "
            f"{4 * n * nb * 32 * 32 * 4}")
        lines.append(
            f"[{mode}] pred planes (int16): {n * nb * 128 * 128 * 2}")
        lines.append(
            f"[{mode}] K2 SATD blocks (int32): {n * nb * 32 * 32 * 4}")
        lines.append(
            f"[{mode}] K2 moment blocks (int32): {n * nb * 5 * 32 * 32 * 4}")
        lines.append(
            f"[{mode}] per-CU cost/cpmvs out (int64+int32): "
            f"{n * lay.cus_per_ctu * (8 + 24)}")
        lines.append(
            f"[{mode}] equation systems M,rhs 2CP (int64): "
            f"{n * lay.cus_per_ctu * (16 + 4) * 8}")
        lines.append(
            f"[{mode}] equation systems M,rhs 3CP (int64): "
            f"{n * lay.cus_per_ctu * (36 + 6) * 8}")
    device = torch.device(device)
    if device.type == "cuda":
        in_use = torch.cuda.memory_allocated(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        in_use = peak = "n/a"
    lines.append(f"device bytes_in_use: {in_use}")
    lines.append(f"device peak_bytes_in_use: {peak}")
    return "\n".join(lines)
