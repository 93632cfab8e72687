"""A torch.profiler trace of one warmed frame-ref, and its device-op table.

Counterpart of the JAX repository's ``tools/xprof_trace.py`` (the reference
reads per-kernel device times through clGetEventProfilingInfo,
main.cpp:862-866): one frame-ref of the default path (the FULL and the HALF
2CP->3CP pair on one reference) runs once to warm up, then once under
``torch.profiler`` with CPU and CUDA activities, inside a ``frame_ref``
range.  On a card the warm-up also captures each pair as a CUDA graph
(``runtime.graphs``), so the profiled frame-ref is two graph replays; the
profiler still records every kernel inside them.  The trace goes to DIR as a Chrome trace (a new temporary directory
without ``--out``), and the tool prints the device ops by self time:

    python -m vvc_affine_tpu_torch.tools.xprof_trace [WxH] [--out DIR]

The input is the JAX tool's: a smooth pattern with noise, shifted by
(3, -2) with more noise, lambda 78.949063.  The summary walks each device
lane of the trace (the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, per (pid, tid); host events such as ``cpu_op`` never
count) as an interval stack and charges each event its self time.  It
prints the top ops with their launch counts, the device's busy share of the
``frame_ref`` window, and the launches of the hand-written kernels, K1
(``warp_kernel``) and K2 (``blockreduce_kernel``); the last line is one
JSON object ``{"xprof_trace": {...}}``.  ``main(argv, device="cpu")`` traces
the plain versions on the CPU (no device lane).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_plane as ap
from vvc_affine_tpu_torch.tools import common

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "frame_ref"
# the hand-written kernels' symbols (csrc/warp.cu, csrc/blockreduce.cu)
HAND_WRITTEN = {"K1": "warp_kernel", "K2": "blockreduce_kernel"}


def frames(fw: int, fh: int):
    """The JAX tool's frame pair, int32 [fh*fw] each."""
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:fh, 0:fw]
    base = 512 + 300 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
    ref = np.clip(base + rng.integers(-64, 64, size=(fh, fw)), 0, 1023)
    orig = np.clip(np.roll(ref, (3, -2), axis=(0, 1))
                   + rng.integers(-24, 24, size=(fh, fw)), 0, 1023)
    return ref.astype(np.int32).ravel(), orig.astype(np.int32).ravel()


def summarize(trace: dict, top: int = 32) -> dict:
    """Device self time per op name from a Chrome trace's events.

    Returns the window (the ``frame_ref`` range, else every event's span),
    the device busy time (the union of the device events), the launches,
    the top ops as (name, self ms, launches), and the launches and self
    time of K1 and K2.
    """
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    lanes = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    self_us, count = {}, {}
    busy = []
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            ts, dur, nm = e["ts"], float(e["dur"]), e["name"]
            while stack and ts >= stack[-1][0] + stack[-1][1]:
                stack.pop()
            if stack:
                self_us[stack[-1][2]] = self_us.get(stack[-1][2], 0.0) - dur
            else:
                busy.append((ts, ts + dur))
            self_us[nm] = self_us.get(nm, 0.0) + dur
            count[nm] = count.get(nm, 0) + 1
            stack.append((ts, dur, nm))
    busy_us = 0.0
    end = None
    for a, b in sorted(busy):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        lo = min((e["ts"] for e in events), default=0.0)
        hi = max((e["ts"] + e["dur"] for e in events), default=0.0)
    rows = sorted(self_us.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": (hi - lo) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (hi - lo) if hi > lo else 0.0,
        "device_launches": sum(count.values()),
        "top_ops": [[k, v / 1e3, count[k]] for k, v in rows],
        "hand_written_launches": {
            k: sum(n for nm, n in count.items() if sym in nm)
            for k, sym in HAND_WRITTEN.items()},
        "hand_written_ms": {
            k: sum(v for nm, v in self_us.items() if sym in nm) / 1e3
            for k, sym in HAND_WRITTEN.items()},
    }


def main(argv=None, device=None) -> int:
    """Trace one warmed frame-ref and print its device ops; ``device``
    overrides ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.xprof_trace",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    parser.add_argument("resolution", nargs="?", default=(1920, 1080),
                        type=common.frame_size, help="WxH (1920x1080)")
    parser.add_argument("--out", default="",
                        help="trace directory (default: a new temporary one)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    fw, fh = args.resolution
    out_dir = args.out or tempfile.mkdtemp(prefix="vvc_xprof_")
    os.makedirs(out_dir, exist_ok=True)

    ref_np, orig_np = frames(fw, fh)
    pairs = {}
    for mode in ("full", "half"):
        s2, s3 = (ap.PlaneSpec(mode, n_cp, fw, fh) for n_cp in (2, 3))
        pairs[mode] = (ap.build_pair_stage(s2, s3, dev),
                       ap.stage_inputs_from_numpy(
                           ref_np, orig_np, 78.949063,
                           ap.zero_cpmvs(s2, "cpu"), dev))

    def one_frame_ref():
        for fn, inputs in pairs.values():
            fn(*inputs)
        common.sync([dev])

    one_frame_ref()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            one_frame_ref()
    path = os.path.join(out_dir, "frame_ref.trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
    with open(path) as f:
        summary = summarize(json.load(f))
    print(f"window {summary['window_ms']:.3f} ms, device busy "
          f"{summary['device_busy_ms']:.3f} ms "
          f"({100 * summary['busy_share']:.1f}%), "
          f"{summary['device_launches']} device launches; " + "; ".join(
              f"{k} {summary['hand_written_launches'][k]} launches "
              f"{summary['hand_written_ms'][k]:.3f} ms"
              for k in HAND_WRITTEN))
    width = max((len(r[0][:80]) for r in summary["top_ops"]), default=4)
    print(f"{'device op (self time)':<{width}}  ms        launches")
    for name, ms, n in summary["top_ops"]:
        print(f"{name[:80]:<{width}}  {ms:9.3f}  {n:8d}")
    print(json.dumps({"xprof_trace": {
        "resolution": f"{fw}x{fh}", "device": common.card_line(dev),
        "trace": path, **summary}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
