"""Per-piece device and host time of one 2CP evaluate of the plane engine.

Counterpart of the JAX repository's ``tools/profile_stage.py``, with its
inputs: a seeded uniform 10-bit frame pair, CPMVs of 52 (3.25 samples)
everywhere and lambda 78.949063, at 1920x1080 FULL unless told otherwise:

    python -m vvc_affine_tpu_torch.tools.profile_stage [WxH] [--half]

Each piece of ``models/affine_plane.py`` — ``prep_inputs``, ``_mv_planes``
(on a card one launch of ``csrc/mvplanes.cu``), K1 (``ops.warp.warp``), K2
(``ops.blockreduce.reduce_blocks``) with and without ``refine``,
``_fold_cu`` (on a card one launch of ``csrc/cufold.cu``) and its plain
twin ``_fold_cu_plain`` (the SATD folds and the normal equations, run on
the device as they are), the solver (``ops.solver.solve_affine``),
``refine_cpmvs``, ``_evaluate`` and the whole stage — gets one line and
one JSON row.  Every piece runs eagerly, the
whole stage too (``affine_plane.eager_stage_fn``): on a card
``build_stage`` replays the stage as one CUDA graph, which has no pieces
to time; ``chip_smoke.py`` times the replay.

* ``event_ms``: the median of 5 runs after a warm one, CUDA events around
  each run (the host clock on the CPU);
* ``host_ms``: the host time of one run, from the call to its return, with
  no profiler (the card may still be working when it returns);
* under ``torch.profiler`` (CPU and CUDA activities), one more run:
  ``device_launches``, the kernels, copies and sets it put on the card,
  and ``device_ms``, their device time (the card's busy time, where
  ``event_ms`` also counts the card waiting for the host);
  ``aten_ops``, the top-level ``aten::`` ops it called (host dispatches);
  ``aten_share``, the share of the run's profiled host time spent inside
  them — the rest is Python between the ops, and the hand-written kernels'
  launches through ``ctypes``.

The last line is one JSON object ``{"profile_stage": {...}}``.  The JAX
tool's R-ladder, rebase, escape fix-up, cost-model guard and knob flags are
TPU workarounds; they are not ported (argparse refuses ``--mxu`` and the
rest).  ``main(argv, device="cpu")`` profiles the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_plane as ap
from vvc_affine_tpu_torch.ops import blockreduce as blockreduce_ops
from vvc_affine_tpu_torch.ops import solver as solver_ops
from vvc_affine_tpu_torch.ops import warp as warp_ops
from vvc_affine_tpu_torch.tools import common

LAMBDA = 78.949063
CPMV = 52
RANGE = "vvc_piece"     # the profiler range around a piece's run


def device_events(events):
    """The kernels, copies and sets among a profiled run's events: the
    device-side events but the GPU side of the piece's own range, which
    spans the whole run."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != RANGE]


def profiled(fn, device: torch.device) -> dict:
    """One run of ``fn()`` under torch.profiler: its device launches and
    their device time, its top-level ``aten::`` ops and their share of the
    run's host time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    common.sync([device])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(RANGE):
            fn()
        common.sync([device])
    events = prof.events()
    span = next(e for e in events if e.name == RANGE
                and e.device_type == torch.autograd.DeviceType.CPU)
    aten = [c for c in span.cpu_children if c.name.startswith("aten::")]
    dev = device_events(events)
    return {"device_launches": len(dev),
            "device_ms": sum(e.device_time_total for e in dev) / 1e3,
            "aten_ops": len(aten),
            "aten_share": (sum(c.cpu_time_total for c in aten)
                           / span.cpu_time_total)}


def host_ms(fn, device: torch.device) -> float:
    """Host milliseconds of one call of ``fn()``, from call to return."""
    common.sync([device])
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    common.sync([device])
    return (t1 - t0) * 1e3


def pieces(spec: ap.PlaneSpec, device: torch.device):
    """(name, fn) of every piece, on the inputs of the JAX tool."""
    t = ap.build_tables(spec, device)
    rng = np.random.default_rng(0)
    n = spec.frame_w * spec.frame_h
    ref_np = rng.integers(0, 1024, size=(n,)).astype(np.int32)
    orig_np = rng.integers(0, 1024, size=(n,)).astype(np.int32)
    zero = ap.zero_cpmvs(spec, device)
    ref, orig, lam, zero = ap.stage_inputs_from_numpy(
        ref_np, orig_np, LAMBDA, zero.cpu(), device)
    orig_pl, _ = ap.prep_inputs(spec, t, ref, orig)
    cp = torch.full((t.n_ctus, t.n_cus, 3, 2), CPMV, dtype=torch.int32,
                    device=device)
    dy, dx, fx, fy = ap._mv_planes(spec, t, cp)

    def warp():
        return warp_ops.warp(ref, spec.frame_w, spec.frame_h, t.ctu_y,
                             t.ctu_x, dy, dx, fx, fy, t.slab_active)

    pred = warp()

    def reduce(refine):
        return blockreduce_ops.reduce_blocks(pred, orig_pl, t.border_packed,
                                             refine, t.repl)

    satd_b, moms_b = reduce(True)
    _, M, rhs = ap._fold_cu(spec, t, satd_b, moms_b, True)
    stage = ap.eager_stage_fn(spec, device)
    return [
        ("prep_inputs", lambda: ap.prep_inputs(spec, t, ref, orig)),
        ("mv_planes", lambda: ap._mv_planes(spec, t, cp)),
        ("K1 warp", warp),
        ("K2 refine", lambda: reduce(True)),
        ("K2 satd only", lambda: reduce(False)),
        ("fold_cu", lambda: ap._fold_cu(spec, t, satd_b, moms_b, True)),
        ("fold_cu_plain",
         lambda: ap._fold_cu_plain(spec, t, satd_b, moms_b, True)),
        ("solver", lambda: solver_ops.solve_affine(M, rhs, spec.n_cp)),
        ("refine_cpmvs", lambda: ap.refine_cpmvs(spec, t, cp, M, rhs)),
        ("evaluate", lambda: ap._evaluate(spec, t, ref, orig_pl, cp, True)),
        ("full stage", lambda: stage(ref, orig, lam, zero)),   # eager
    ]


def main(argv=None, device=None) -> int:
    """Profile every piece; ``device`` overrides ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.profile_stage",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    parser.add_argument("resolution", nargs="?", default=(1920, 1080),
                        type=common.frame_size, help="WxH (1920x1080)")
    parser.add_argument("--half", action="store_true",
                        help="the HALF (half-aligned CU) mode, not FULL")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    fw, fh = args.resolution
    spec = ap.PlaneSpec("half" if args.half else "full", 2, fw, fh)
    rows = []
    print(f"profile_stage {spec.mode} 2CP {fw}x{fh} on "
          f"{common.card_line(dev)}", flush=True)
    for name, fn in pieces(spec, dev):
        row = {"piece": name, "event_ms": common.median_ms(fn, dev),
               "host_ms": host_ms(fn, dev), **profiled(fn, dev)}
        rows.append(row)
        print(f"{name:<19} {row['event_ms']:9.3f} ms  host "
              f"{row['host_ms']:9.3f} ms  device {row['device_ms']:8.3f} ms "
              f"in {row['device_launches']:6d} launches  aten ops "
              f"{row['aten_ops']:6d} ({100 * row['aten_share']:.1f}% of host "
              f"time)", flush=True)
    print(json.dumps({"profile_stage": {
        "mode": spec.mode, "resolution": f"{fw}x{fh}",
        "device": common.card_line(dev), "pieces": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
