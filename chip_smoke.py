#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order (any failure exits non-zero before the result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every kernel from ``vvc_affine_tpu_torch/csrc`` with nvcc;
3. K1 (warp) against its plain version ``warp_xla`` at 1080p shapes, both
   alignment modes, random phases and displacements up to |d| = 300 (windows
   past every frame edge): tolerance 0, bit equality of the int16 planes;
4. K2 (block reduction) against its plain version at 1080p shapes, refine on
   and off and the one-bin broadcast: tolerance 0 on the valid slots of
   in-frame CUs (the only outputs the engine reads);
5. the port on the card (kernels, through the entry points' default
   device) against the port on the CPU (plain versions): one 2CP->3CP pair
   per mode at 416x240, bit-identical costs and CPMVs;
6. the main path: ``cli.main`` at 1920x1080, -f 2, -q 32 on synthetic
   affine-motion content, with the launch counts zeroed just before and
   read just after (K1 must launch 60 times, K2 66), and the decision logs
   checked for row count, shape and range;
7. per-kernel times at the main path's 1080p shapes (CUDA events over
   bare back-to-back launches, and over the whole wrapper), their bounds,
   and the plain versions' times: the FULL shapes go into the one
   ``kernels`` JSON line, the HALF shapes into ``[time]`` lines;
8. with ``--profile`` only: under torch.profiler, each kernel's device
   time per launch on the phase-7 inputs, and per mode one 1080p pair on
   the main path's content — its device-busy time, idle share, device
   launches and the two kernels' device time per launch (``[profile]``
   lines).

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet rates: HBM bytes/s, and the 32-bit rate outside the
# tensor cores (the kernels are integer work on the CUDA cores; the table of
# published peaks has no separate integer rate, so this one bounds them).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

FW, FH = 1920, 1080
SMALL_W, SMALL_H = 416, 240
REPLACES = {"warp": "vvc_affine_tpu/ops/warp.py:252",
            "blockreduce": "vvc_affine_tpu/ops/blockreduce.py:147"}


def _require(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _median_ms(fn, reps=5, inner=10):
    """Median per-call time of fn() on the card, CUDA events, after warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return sorted(times)[len(times) // 2]


def card_info():
    """Phase 1: the card line (nvidia-smi) and the software versions."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi.strip().splitlines()[0]


def build_kernels():
    """Phase 2: nvcc every source; print the seconds and ptxas' summary."""
    from vvc_affine_tpu_torch import kernels

    build_s = kernels.build()
    print(f"[build] {build_s:.1f} s", flush=True)
    for src, log in sorted(kernels.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)


def _valid_slots(t):
    """bool [nCtu, nBins, NB, NB]: slots of in-frame CUs, per bin."""
    import torch

    from vvc_affine_tpu_torch import planes as P

    out = torch.zeros((t.n_ctus, t.n_bins, P.NB, P.NB), dtype=torch.bool,
                      device=t.within.device)
    for ci, cp_tab in enumerate(t.cls):
        s = t.strides[ci]
        w = t.within[:, s:s + cp_tab.num_cus].to(torch.int32)
        cover = P.spread_cu_to_slots(w, cp_tab).bool()
        out[:, int(t.bin_of[ci])] |= cover & t.cls_t[ci].slot_valid
    return out


def check_warp(tables, ref, rng):
    """Phase 3: K1 == warp_xla, bit for bit.  Returns per-mode arguments
    for the timing phase and the error."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch.ops import warp as wp

    dev = ref.device
    out = {}
    for mode, t in tables.items():
        shape = (t.n_ctus, t.n_bins, 32, 32)
        d = rng.integers(-8, 9, size=(2,) + shape)
        far = rng.random((2,) + shape) < 0.03
        d = np.where(far, rng.integers(-300, 301, size=(2,) + shape), d)
        dy, dx = (torch.as_tensor(v.astype(np.int32), device=dev) for v in d)
        fx, fy = (torch.as_tensor(rng.integers(0, 16, size=shape)
                                  .astype(np.int32), device=dev)
                  for _ in range(2))
        ones = torch.ones((t.n_ctus, t.n_bins, 16), dtype=torch.int32,
                          device=dev)
        want = wp.warp_xla(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx,
                           wp.tap_planes(fx), wp.tap_planes(fy))
        got = wp.warp(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx, fx, fy, ones)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want).abs().max())
        _require(err == 0, f"K1 {mode}: max |err| {err} vs warp_xla")
        # with the engine's slab mask: equal on every active slab
        got = wp.warp(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx, fx, fy,
                      t.slab_active)
        rows = t.slab_active.repeat_interleave(8, dim=-1).bool()[..., None]
        err_act = int(((got.to(torch.int32) - want).abs() * rows).max())
        _require(err_act == 0, f"K1 {mode}: active slabs differ")
        out[mode] = dict(err=max(err, err_act),
                         args=(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx, fx, fy,
                               t.slab_active),
                         act=float(t.slab_active.float().mean()))
        print(f"[K1] {mode}: bit-equal to warp_xla ({t.n_ctus}x{t.n_bins} "
              f"planes, |d| <= 300)", flush=True)
    return out


def check_blockreduce(tables, orig_pl, rng):
    """Phase 4: K2 == the plain reduction on the valid slots, bit for bit."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch.ops import blockreduce as br

    dev = orig_pl.device
    out = {}
    for mode, t in tables.items():
        valid = _valid_slots(t)
        for pred_bins, refine in ((t.n_bins, True), (t.n_bins, False),
                                  (1, True)):
            pred = torch.as_tensor(
                rng.integers(0, 1024, size=(t.n_ctus, pred_bins, 128, 128))
                .astype(np.int16), device=dev)
            s_want, m_want = br.reduce_blocks_plain(
                pred, orig_pl, t.border_packed, refine)
            s_got, m_got = br.reduce_blocks(
                pred, orig_pl, t.border_packed, refine)
            torch.cuda.synchronize()
            err = int(((s_got - s_want).abs() * valid).max())
            if refine:
                err = max(err, int(((m_got - m_want).abs()
                                    * valid[:, :, None]).max()))
            else:
                _require(m_got is None, "K2 refine=False returned moments")
            _require(err == 0, f"K2 {mode} bins={pred_bins} refine={refine}"
                               f": max |err| {err}")
            if pred_bins == t.n_bins and refine:
                out[mode] = dict(err=err,
                                 args=(pred, orig_pl, t.border_packed, True))
            print(f"[K2] {mode} pred_bins={pred_bins} refine={refine}: "
                  f"bit-equal on valid slots", flush=True)
    return out


def check_card_vs_cpu():
    """Phase 5: one pair per mode on the card, through the entry points'
    default device, equals the CPU run."""
    import torch

    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.models import affine_plane as ap

    o_np, r_np = testing.affine_gop(SMALL_W, SMALL_H, 1, seed=5)
    for mode in ("full", "half"):
        specs = (ap.PlaneSpec(mode, 2, SMALL_W, SMALL_H),
                 ap.PlaneSpec(mode, 3, SMALL_W, SMALL_H))
        outs = []
        # the card side takes every entry point's default device
        for d in (None, torch.device("cpu")):
            z = ap.zero_cpmvs(specs[0], d)
            args = ap.stage_inputs_from_numpy(r_np[0], o_np[0], 57.54,
                                              z.cpu(), d)
            _require(args[0].device.type == ("cpu" if d else "cuda"),
                     f"inputs on {args[0].device} for device={d}")
            outs.append([o.cpu() for o in
                         ap.build_pair_stage(*specs, device=d)(*args)])
        for name, a, b in zip(("cost2", "cpmvs2", "cost3", "cpmvs3"), *outs):
            _require(a.dtype == b.dtype and torch.equal(a, b),
                     f"{mode} {name}: card differs from CPU")
        print(f"[stage] {mode} pair at {SMALL_W}x{SMALL_H}: card == CPU "
              f"(costs int64, CPMVs int32)", flush=True)


def run_main_path(n_ctu):
    """Phase 6: the CLI at 1080p; returns the launch counts of the run."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import cli, kernels, testing
    from vvc_affine_tpu_torch.runtime import frames as frames_io
    from vvc_affine_tpu_torch.runtime import reporting

    with tempfile.TemporaryDirectory() as tmp:
        orig_g, recon_g = testing.affine_gop(FW, FH, 2, seed=0)
        opath, rpath = (os.path.join(tmp, f) for f in ("orig.csv", "ref.csv"))
        frames_io.write_frames_csv(opath, orig_g)
        frames_io.write_frames_csv(rpath, recon_g)
        prefix = os.path.join(tmp, "log")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        rc = cli.main(["-f", "2", "-s", f"{FW}x{FH}", "-q", "32",
                       "-o", opath, "-r", rpath, "-l", prefix])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        launches = dict(kernels.launches)
        _require(rc == 0, f"cli.main returned {rc}")
        _require(launches == {"warp": 60, "blockreduce": 66},
                 f"main path launches {launches}, want warp 60 and "
                 f"blockreduce 66")
        n_rows = 0
        for pred in range(4):
            for path in reporting.log_paths(prefix, pred):
                a = np.loadtxt(path, delimiter=",", skiprows=1,
                               dtype=np.int64, ndmin=2)
                _require(a.shape[1] == 14, f"{path}: {a.shape[1]} columns")
                _require(((a[:, 7] >= 0) & (a[:, 7] < 1 << 62)).all(),
                         f"{path}: cost out of range")
                _require((np.abs(a[:, 8:]) <= 1 << 17).all(),
                         f"{path}: CPMV out of range")
                n_rows += a.shape[0]
        want_rows = 3 * n_ctu * 2 * (201 + 284)    # 3 frame-refs
        _require(n_rows == want_rows, f"{n_rows} log rows, want {want_rows}")
    print(json.dumps({"main_path": {"cli_s": cli_s, "launches": launches,
                                    "log_rows": n_rows}}), flush=True)
    return launches


def _warp_cost(t, act):
    """Bytes and operations K1 needs for one call on this run's data: the
    frame once, the CTU corners and slab mask, and on active slabs the four
    int32 motion planes in and the int16 planes out; per 4x4 block,
    9x4x6 + 4x4x6 multiply-adds of the separable filter (2 ops each)."""
    n = t.n_ctus * t.n_bins
    nbytes = (FW * FH * 4 + 2 * t.n_ctus * 4 + n * 16 * 4
              + act * n * (4 * 1024 * 4 + 16384 * 2))
    return nbytes, act * n * 1024 * 2 * (9 * 4 * 6 + 4 * 4 * 6)


def _blockreduce_cost(t):
    """Bytes and operations K2 needs with moments: int16 planes, the int32
    original CTUs and border masks in; SATD and five moments out.  Per
    sample about 50 integer operations: SATD ~12 (difference, butterflies,
    abs, sum), Sobel 2 x 12, replication selects ~4, products and sums 10."""
    n = t.n_ctus * t.n_bins
    nbytes = (n * 16384 * 2 + t.n_ctus * 16384 * 4 + t.n_bins * 16384 * 4
              + n * 1024 * 4 * 6)
    return nbytes, n * 16384 * (12 + 24 + 4 + 10)


def time_kernels(tables, warp_stats, br_stats, launches):
    """Phase 7: kernel and plain-version times at the 1080p shapes.

    ``ms`` times the bare launches of a kernel bound once to its inputs and
    preallocated outputs, back to back, so the device queue never drains:
    the kernel's own time.  ``wrapper_ms`` times the whole wrapper (input
    checks, output allocation, binding) as the engine calls it.  Returns
    the FULL rows and, per (mode, kernel), the bound launcher for phase 8.
    """
    from vvc_affine_tpu_torch.ops import blockreduce as br
    from vvc_affine_tpu_torch.ops import warp as wp

    rows, bound = [], {}
    for mode, t in tables.items():
        a = warp_stats[mode]["args"]
        plain = lambda a=a: wp.warp_xla(*a[:7], wp.tap_planes(a[7]),
                                        wp.tap_planes(a[8]))
        b = br_stats[mode]["args"]
        # the outputs stay referenced here while their launchers run
        bound[mode, "warp"] = wp.bind_warp(*a)
        bound[mode, "blockreduce"] = br.bind_reduce_blocks(*b)
        for name, fn, plain_fn, (nbytes, ops), err in (
                ("warp", lambda a=a: wp.warp(*a), plain,
                 _warp_cost(t, warp_stats[mode]["act"]),
                 warp_stats[mode]["err"]),
                ("blockreduce", lambda b=b: br.reduce_blocks(*b),
                 lambda b=b: br.reduce_blocks_plain(*b), _blockreduce_cost(t),
                 br_stats[mode]["err"])):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / OPS_PER_S * 1e3
            row = {
                "name": name, "route": "cuda",
                "source": f"vvc_affine_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err,
                "ms": _median_ms(bound[mode, name][-1], 5, 20),
                "wrapper_ms": _median_ms(fn),
                "plain_ms": _median_ms(plain_fn, 3, 2),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "shape": f"1080p {mode}: {t.n_ctus} CTUs x {t.n_bins} bins"}
            if mode == "full":
                rows.append(row)
            else:
                print(f"[time] {json.dumps(row)}", flush=True)
    return rows, bound


_KERNEL_SYMBOLS = {"warp": "warp_kernel", "blockreduce": "blockreduce_kernel"}


def _device_events(fn):
    """Run fn() once under torch.profiler; the CUDA-side events."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def _kernel_ms(events, name):
    """(launches, device ms per launch) of kernel ``name`` in the events."""
    us = [ev.device_time_total for ev in events
          if _KERNEL_SYMBOLS[name] in ev.name]
    return len(us), (sum(us) / len(us) / 1e3 if us else None)


def profile_kernels(bound, n=20):
    """Phase 8a: each kernel's device time per launch under the profiler, on
    the phase-7 inputs, beside phase 7's event time of the same launches."""
    for (mode, name), bound_args in bound.items():
        run = bound_args[-1]
        count, ms = _kernel_ms(
            _device_events(lambda: [run() for _ in range(n)]), name)
        _require(count == n, f"profiler saw {count} {name} launches, not {n}")
        row = {"kernel": name, "mode": mode, "inputs": "phase 7",
               "device_ms_per_launch": ms}
        print(f"[profile] {json.dumps(row)}", flush=True)


def profile_pairs():
    """Phase 8b: where a 1080p 2CP->3CP pair's time goes, per mode, on the
    main path's content (``affine_gop`` seed 0: POC 1 against the POC 0
    reconstruction at QP 32, the main path's first pair): the pair's CUDA-event time under the profiler, the
    device time of every kernel and copy in it, the device's idle share,
    and the two hand-written kernels' launches and device time per launch."""
    import torch

    from vvc_affine_tpu_torch import constants as C
    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.models import affine_plane as ap

    orig, recon = testing.affine_gop(FW, FH, 2, seed=0)
    for mode in ("full", "half"):
        specs = (ap.PlaneSpec(mode, 2, FW, FH), ap.PlaneSpec(mode, 3, FW, FH))
        fn = ap.build_pair_stage(*specs)
        args = ap.stage_inputs_from_numpy(recon[0], orig[0],
                                          C.lambda_for(32, 1),
                                          ap.zero_cpmvs(specs[0], "cpu"), None)
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def pair():
            start.record()
            fn(*args)
            end.record()

        events = _device_events(pair)
        pair_ms = start.elapsed_time(end)
        busy_ms = sum(ev.device_time_total for ev in events) / 1e3
        row = {"mode": mode, "frame": f"{FW}x{FH}", "pair_ms": pair_ms,
               "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / pair_ms,
               "device_launches": len(events)}
        for name in _KERNEL_SYMBOLS:
            row[f"{name}_launches"], row[f"{name}_ms_per_launch"] = (
                _kernel_ms(events, name))
        print(f"[profile] {json.dumps(row)}", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 8: torch.profiler device times of "
                             "the kernels and of a 1080p pair per mode")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.models import affine_plane as ap

    dev = torch.device("cuda:0")
    t_start = time.time()
    card = card_info()
    build_kernels()

    rng = np.random.default_rng(2026)
    tables = {m: ap.build_tables(ap.PlaneSpec(m, 2, FW, FH), dev)
              for m in ("full", "half")}
    orig_np, ref_np = (f[0].astype(np.int32).reshape(-1)
                       for f in testing.affine_gop(FW, FH, 1, seed=3))
    ref = torch.as_tensor(ref_np, device=dev)
    orig_pl, _ = ap.prep_inputs(ap.PlaneSpec("full", 2, FW, FH),
                                tables["full"],
                                torch.as_tensor(orig_np, device=dev), ref)
    warp_stats = check_warp(tables, ref, rng)
    br_stats = check_blockreduce(tables, orig_pl, rng)
    check_card_vs_cpu()
    launches = run_main_path(tables["full"].n_ctus)
    rows, bound = time_kernels(tables, warp_stats, br_stats, launches)
    if args.profile:
        profile_kernels(bound)
        profile_pairs()

    print(f"[total] {time.time() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
