#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--profile] [--ab DIR [--ab-k2-masks]] [--tracing-only]

Phases, in order (any failure exits non-zero before the result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every kernel from ``vvc_affine_tpu_torch/csrc`` with nvcc, and the
   native runtime library (``native/``) with g++; then build the 1080p
   tables of both modes and check that K2's replication flags derived on
   the card (``ops.blockreduce.replication_flags``) equal the table built
   on the host that the engine reads (``PlaneTables.repl``);
3. K1 (warp) against its plain version ``warp_xla`` at 1080p shapes, both
   alignment modes, on every field family: random phases and displacements
   up to |d| = 300, a smooth zoom and rotation (CPMVs through the engine's
   ``_mv_planes``), windows exactly at and one sample past the edges of
   each strip's staged region, every block but the strips' centres on the
   global path, and windows pulled past each frame edge; every CTU, so
   every strip at every frame border.  Tolerance 0, bit equality of the
   int16 planes; the share of blocks on K1's global path per field;
4. K2 (block reduction) against its plain version at 1080p shapes, refine on
   and off and the one-bin broadcast: tolerance 0 on the valid slots of
   in-frame CUs (the only outputs the engine reads);
5. the port on the card (kernels, through the entry points' default
   device) against the port on the CPU (plain versions): one 2CP->3CP pair
   per mode at 416x240, called twice on the card (the warm-up that
   captures the pair's CUDA graph, then a replay), each bit-identical to
   the CPU's costs and CPMVs;
5b. the motion-plane kernel (``csrc/mvplanes.cu``, ``check_mvplanes``):
   against its plain version on the card, bit for bit, at 1920x1080 and
   3840x2160 (also padded to 512 CTUs and as the split's last shard), both
   modes, 2CP and 3CP, on random CPMVs, CPMVs at +-MV_MAX, CUs spread over
   the limit, zero CPMVs, the four mixed, zoom and rotation; its time
   beside its bytes bound and the plain version's; a captured 1080p pair
   per mode replayed once: 10 motion-plane launches, outputs equal to the
   eager oracle's and to the eager pair with the plain motion planes, and
   the graphs' nodes per frame-ref (a ``mvplanes`` JSON line);
5c. the CU fold kernel (``csrc/cufold.cu``, ``check_cufold``): against
   its plain version ``_fold_cu_plain`` on the card, bit for bit, at
   1920x1080 and 3840x2160 (also padded to 512 CTUs and as the split's
   last shard), both modes, 2CP and 3CP with the equations and SATD only,
   on K2's outputs for ``mebench/frames.py`` content under zero, random,
   zoom and rotation CPMVs, and on random K2 outputs at their extremes;
   its time (bare launches) beside its bytes bound and the plain
   version's; a captured 1080p pair per mode replayed once: 11 CU fold
   launches, outputs equal to the eager oracle's and to the eager pair
   with the plain fold, and the graphs' nodes per frame-ref (a ``cufold``
   JSON line);
6. the main path: ``cli.main`` at 1920x1080, -f 2, -q 32 on synthetic
   affine-motion content, with the launch counts zeroed just before and
   read just after (K1 must launch 60 times, K2 66, the motion-plane
   kernel 60, the CU fold 66), and the decision logs
   checked for row count, shape and range.  Every pair on the card is one
   CUDA graph (``runtime/graphs.py``): the first frame-ref warms up and
   captures, the other two replay; the run's peak device memory;
6b. the graphs against the eager loop they capture: (a) per mode at
   1920x1080, a new captured pair fed four different input sets in turn
   (one warm-up, three replays) and the 2CP and 3CP stages likewise, every
   output bit-identical to the eager loop's (``eager_pair_fn``,
   ``eager_stage_fn``) on the same set, also after the later replays, and
   each call launching 10 K1, 11 K2, 10 motion-plane and 11 CU fold
   kernels; (b) the 1080p -f 2 pipeline with each pair run eagerly: its 40
   logs byte-identical to phase 6's, K1/K2/motion planes/CU fold
   60/66/60/66; (c) a ``graph`` JSON line: seconds per frame-ref of the
   eager run
   and of phase 6 (its first, capturing frame-ref apart), capture seconds
   per pair and stage, K1/K2 launches, device memory of both runs, and
   with ``--profile`` the device busy share of a replayed and of an eager
   frame-ref (phase 8b);
7. per-kernel times at the main path's 1080p shapes (CUDA events over
   bare back-to-back launches, and over the whole wrapper), their bounds,
   and the plain versions' times; and ``ms_path``: every K1 and K2 launch
   of one 1080p pair per mode of the main path (the eager pair, whose
   launches carry their inputs), captured and timed the same way, beside
   its bound, with the loaded kernels' registers, local memory and shared
   memory (``kernels.attributes``).  The FULL shapes go
   into the one ``kernels`` JSON line, the HALF shapes into ``[time]``
   lines, the per-launch times into ``[path]`` lines.  With ``--ab DIR``:
   the ``warp.cu`` and ``blockreduce.cu`` in DIR (another version of
   ``csrc/``, built and bound through ``kernels.source_dir``) against this
   tree's on the captured launches, outputs first checked equal, then
   timed in turns (other, this, this, other; ``[ab]`` lines);
8. with ``--profile`` only: under torch.profiler, each kernel's device
   time per launch on the phase-7 inputs, and per mode one 1080p pair on
   the main path's content, replayed and eager — its device-busy time,
   idle share, device launches and the two kernels' device time per
   launch (``[profile]`` lines);
9. the probe path: ``tools.mosaic_probe.main`` with the launch counts
   zeroed just before and read just after (each of the six probe kernels
   once), then each probe kernel against its plain version and the numpy
   window at the tool's offset and the edges of its defined range
   (tolerance 0), and its time beside an empty launch's; the probe rows go
   into the ``kernels`` line;
10. the CLI's single-card flags at 416x240, -f 2: an uninterrupted run with
   -l; a run with -f 1 and then -f 2 on one --CheckpointDir, whose logs must
   equal the uninterrupted run's byte for byte; a run with --PerPredTiming
   (each stage its own graph, captured while the trace samples),
   --DeviceTrace and --MemoryReport, whose logs must equal the
   uninterrupted run's, whose trace must vary and whose trace and report
   must show a peak above the bytes the earlier phases left allocated.  Each
   run's K1/K2 launches are counted as in phase 6;
11. the gather engine (``--Engine gather``, plain PyTorch ops, no kernel of
   its own; on the card each stage is one CUDA graph of them): (a) its
   ops on the card against the CPU, tolerance 0 — ``predict_subblocks``
   on windows at and past each frame edge with all 16x16 phase pairs,
   ``filter_windows(last=False)``, ``sobel_cu``, ``gradient_moments`` on
   extreme gradients and ``assemble_system``; (b) one 2CP->3CP chain per
   mode at 416x240, called twice on the card (default device; the first
   call captures the stage graphs, the second replays them on another
   input set), each bit-identical to the gather chain on the CPU and the
   plane pair on the card; (c) ``cli.main --Engine gather`` at 1920x1080,
   -f 2, -q 32 on phase 6's CSVs, with every kernel's launch count 0, and
   every decision log byte-identical to phase 6's plane-engine logs (a
   ``gather_path`` JSON line with the CUDA-event seconds of each of the 12
   stages, per frame-ref the first, capturing one apart from the
   replayed ones, and the run's peak memory; with ``--profile``,
   ``[profile]`` lines with the device launches, busy time and idle share
   of one FULL and one HALF 2CP stage, eager and then replayed); (d) phase
   6's two CSVs parsed by the native library and by the plain Python
   parser, equal arrays, both times on ``[native]`` lines; (e) per (mode,
   n_cp) the 1080p stage graph that (c) captured, fed the four input sets
   of phase 6b in turn (3CP on its 2CP output), each output bit-identical
   to the eager loop's (``affine_me.eager_stage_fn``), also after the
   later replays, no kernel launched (a ``gather_graph`` JSON line:
   capture seconds per stage, replayed and eager seconds per set, kernel
   launches per replay);
12. the CTU-axis split (``parallel/mesh.py``, ``runtime/distributed.py``)
   held on the one card: (a) ``AffineMEPipeline`` with ``mesh=make_mesh(
   [cuda:0] * N)``, N = 2 and 4 (135 CTUs pad to 136, so a padding CTU
   runs), at 1920x1080 -f 2 on phase 6's CSVs, logs written through
   ``reporting``: all 40 byte-identical to phase 6's, K1 launched N x 60,
   K2 N x 66, the motion-plane kernel N x 60 and the CU fold N x 66
   times; on a machine with N cards also ``cli.main --NumChips N`` over N
   distinct cards; (b) two processes of ``python -m
   vvc_affine_tpu_torch.cli --Coordinator 127.0.0.1:<free port>
   --NumProcesses 2 --ProcessId k`` on card 0 (and, with two cards, on
   card k) and phase 6's CSVs: both exit 0 within a timeout (else both are
   killed and the phase fails), process 0's 40 logs byte-identical to
   phase 6's, process 1's none; (c) the same two processes at 416x240 with
   --CheckpointDir, -f 1 and then -f 2 resumed: process 0's logs equal an
   uninterrupted one-process run's, process 1's none; (d) the gather
   engine's 1080p -f 2 pipeline split over 2 shards on card 0 (one graph
   per stage holding both shards, captured and replayed twice): logs ==
   phase 6's, no kernel launch; (e) two processes with ``--Engine
   gather`` at 416x240: process 0's logs equal the one-process run's,
   process 1's none.  A ``split`` JSON line gives the seconds per
   frame-ref (the CUDA-event pair or stage times of the CLI's timing
   report, FULL + HALF) of phase 6, (a), (b), (d) and (e).  On the CPU
   the same split is held against the JAX package by
   ``tests/test_torch_{stage,cli,distributed}.py`` (CPU shards, two and
   four CPU processes over gloo);
13. the measurement tools (``vvc_affine_tpu_torch/tools``), each run as
   ``python -m vvc_affine_tpu_torch.tools.<name>`` in a child process of
   its own session, killed with every process it started if it outlives
   its timeout: (a) ``power_trace`` around the 1080p -f 2 CLI on phase 6's
   CSVs (its logs must be phase 6's), then ``energy_report`` on its trace
   and log: every power sample a number above 0 W, every EXEC window
   sampled, every phase's mean power at most the card's power limit
   (``[energy]`` lines, the joules per frame-ref); (b) ``profile_stage``
   at 1080p, FULL and ``--half`` (``[profile_stage]`` lines: each piece's
   CUDA-event and host time, device launches, aten ops and their share of
   the host time); (c) ``xprof_trace`` at 1080p, which must find K1 and
   K2 among the device ops of one frame-ref, at most the 20 and 22
   launched (the profiler may miss a few of its ~68k device events;
   ``[xprof]`` lines); (d) ``tpu_parity`` at 832x480: every stage's costs and CPMVs on
   the card bit-identical to the CPU golden of its child; (e)
   ``gop_golden`` at 3840x2160 -f 2 (510 CTUs, 3 frame-refs: the first
   captures the graphs, two replay): the plane and the gather CLI's 40
   logs byte-identical, K1/K2/motion planes/CU fold launched 60/66/60/66
   times in the plane child and none in the gather child, each child's
   first frame-ref, replayed frame-refs and peak memory on ``[tools]``
   lines;
   (f) ``scaling_bench``
   at 1080p over 1, 2 and 4 shards (card 0 repeated where there are fewer
   cards): the same result digest for every count (``[scaling]`` lines);
   (g) in this process, one pair per mode at 3840x2160 on gop_golden's
   first frame pair under the profiler, 10 K1 and 11 K2 launches each by
   the wrappers' counts (``[profile]`` lines: K1/K2 device time per launch
   at 4K, the pair's idle share).  A ``tools`` JSON line sums them up;
14. the span-and-counter recorder (``runtime/tracing.py``) at 1920x1080,
   -f 3 (6 frame-refs; the first captures), for the plane and the gather
   pipeline on card 0 and the plane pipeline split over 2 cards (card 0
   twice where there is one), each on graphs captured anew (the builders'
   caches are cleared, so earlier phases' graphs are not reused): the
   ``graphs.nodes`` (per graph, by type, read through the CUDA driver at
   the first replayed frame-ref) must equal the graphs' own; a second
   pipeline of the same configuration, captured with the recorder off and
   then replayed under one, must count the same nodes; per replayed
   frame-ref ``graphs.nodes_replayed`` must equal the sum of its graphs'
   nodes and ``graphs.replays`` their number; every replay's
   ``graphs.replay.device`` events must have resolved at the drain after
   the frame-ref's readback, with nothing else synchronised; the
   ``graphs.*`` spans nest under ``pipeline.dispatch`` (through
   ``mesh.issue`` of their card in the split) and ``graphs.capture``
   sums to the graphs' ``capture_s``; with the recorder off a replayed
   frame-ref records no CUDA event.  A ``tracing`` JSON line per
   configuration: nodes per graph and per frame-ref, per card device and
   issue ms per frame-ref, staging ms, capture seconds.  ``--tracing-only``
   runs phases 1, 2 and 14 alone.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
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
            "blockreduce": "vvc_affine_tpu/ops/blockreduce.py:147",
            **{f"probe_{p}": f"tools/mosaic_probe.py:{line}" for p, line in (
                ("k_a", 59), ("k_b", 63), ("k_c", 69), ("k_d_rows", 78),
                ("k_d_lanes", 82), ("k_e", 74))}}
# K1, K2, motion-plane and CU fold launches per 2CP->3CP pair, FULL + HALF,
# per frame-ref
PAIR_LAUNCHES = {"warp": 20, "blockreduce": 22, "mvplanes": 20,
                 "cufold": 22}
# phase 5b's kinds of CPMVs
MV_KINDS = ("random", "mv_max", "spread", "zero", "mixed", "zoom",
            "rotation")


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
    """Phase 2: nvcc every source and g++ the native runtime library;
    print the seconds and ptxas' summary."""
    from vvc_affine_tpu_torch import kernels, native

    build_s = kernels.build()
    print(f"[build] {build_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    native.get_lib()
    print(f"[build] native runtime library {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, log in sorted(kernels.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {os.path.relpath(src)}: {line.strip()}",
                      flush=True)


def _valid_slots(t):
    """bool [nCtu, nBins, NB, NB]: slots of in-frame CUs, per bin."""
    import torch

    from vvc_affine_tpu_torch import planes as P

    out = torch.zeros((t.n_ctus, t.n_bins, P.NB, P.NB), dtype=torch.bool,
                      device=t.within.device)
    for ci, cp_tab in enumerate(t.cls):
        s = t.strides[ci]
        w = t.within[:, s:s + cp_tab.num_cus].to(torch.int32)
        cover = P.spread_cu_to_slots(w, cp_tab,
                                     t.cls_t[ci].cu_index).bool()
        out[:, int(t.bin_of[ci])] |= cover & t.cls_t[ci].slot_valid
    return out


def _cpmv_field(t, spec, kind):
    """CPMVs int32 [nCtu, nCU, 3, 2] (1/16 pel) of a global zoom or
    rotation about the frame centre, at every CU's three control points."""
    import numpy as np
    import torch

    if kind == "zoom":
        a = np.array([[0.02, 0.0], [0.0, 0.02]])
    else:                                        # rotation by 1.5 degrees
        th = np.deg2rad(1.5)
        a = np.array([[np.cos(th) - 1, -np.sin(th)],
                      [np.sin(th), np.cos(th) - 1]])
    x0, y0 = (v.cpu().numpy().astype(np.float64) for v in (t.abs_x, t.abs_y))
    w = t.cu_w.cpu().numpy()[None, :]
    h = t.cu_h.cpu().numpy()[None, :]
    pts = [(x0, y0), (x0 + w, y0), (x0, y0 + h)]
    cp = np.stack([np.stack([a[0, 0] * (x - FW / 2) + a[0, 1] * (y - FH / 2),
                             a[1, 0] * (x - FW / 2) + a[1, 1] * (y - FH / 2)],
                            axis=-1) for x, y in pts], axis=-2)
    return torch.as_tensor(np.rint(16 * cp).astype(np.int32),
                           device=t.within.device)


def _edge_field(t, rng, past, dev):
    """Displacements that put each block's window exactly at (``past`` 0)
    or one sample past (1) an edge of its strip's staged region: per strip
    and group of bins a random centre displacement, every other block at a
    region edge chosen at random."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch.ops import warp as wp

    n = (t.n_ctus, t.n_bins, 4)
    # one centre per group of bins: the group shares its region
    g = wp.group_bins(n[1])
    cyx = rng.integers(-40, 41, size=(2, n[0], -(-n[1] // g), 4, 1, 1))
    cyx = np.repeat(cyx, g, axis=2)[:, :, :n[1]]
    byl = 4 * np.arange(8)[:, None]
    bx = 4 * np.arange(32)[None, :]
    out = []
    for c, blk, m, hi in ((cyx[0], byl, wp.MY, wp.RH - 9),
                          (cyx[1], bx, wp.MX, wp.RW - 9)):
        w = np.where(rng.random(n + (8, 32)) < 0.5, -past, hi + past)
        d = c + w - blk - m                       # window origin at w
        d[..., 4, 16] = c[..., 0, 0]              # the centre block
        out.append(torch.as_tensor(d.reshape(n[:2] + (32, 32))
                                   .astype(np.int32), device=dev))
    return out


def _warp_fields(t, mode, rng, dev):
    """Phase 3's motion fields, name -> (dy, dx, fx, fy) int32
    [nCtu, nBins, 32, 32]."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch.models import affine_plane as ap

    shape = (t.n_ctus, t.n_bins, 32, 32)

    def phases():
        return [torch.as_tensor(rng.integers(0, 16, size=shape)
                                .astype(np.int32), device=dev)
                for _ in range(2)]

    fields = {}
    d = rng.integers(-8, 9, size=(2,) + shape)
    far = rng.random((2,) + shape) < 0.03
    d = np.where(far, rng.integers(-300, 301, size=(2,) + shape), d)
    fields["random |d|<=300"] = [torch.as_tensor(v.astype(np.int32),
                                                 device=dev) for v in d]
    fields["random |d|<=300"] += phases()
    spec = ap.PlaneSpec(mode, 2, FW, FH)
    for kind in ("zoom", "rotation"):
        fields[kind] = list(ap._mv_planes(spec, t, _cpmv_field(t, spec, kind)))
    for past in (0, 1):
        fields[f"region edge +{past}"] = _edge_field(t, rng, past, dev) \
            + phases()
    # every block but each strip's centre 40 rows from the centre's motion
    dy, dx = _edge_field(t, rng, 0, dev)
    cy = dy.reshape(t.n_ctus, t.n_bins, 4, 8, 32)[:, :, :, 4:5, 16:17]
    glob = torch.full_like(dy.reshape(cy.shape[:3] + (8, 32)), 40) + cy
    glob[:, :, :, 4, 16] = cy[..., 0, 0]
    fields["global path"] = [glob.reshape(shape), dx] + phases()
    # windows pulled past each frame edge (staged, clamped)
    for name, ddy, ddx in (("top", -FH, 0), ("bottom", FH, 0),
                           ("left", 0, -FW), ("right", 0, FW)):
        fields[f"past {name} edge"] = [
            torch.full(shape, ddy, dtype=torch.int32, device=dev)
            + torch.as_tensor(rng.integers(-3, 4, size=shape)
                              .astype(np.int32), device=dev),
            torch.full(shape, ddx, dtype=torch.int32, device=dev)
            + torch.as_tensor(rng.integers(-3, 4, size=shape)
                              .astype(np.int32), device=dev)] + phases()
    return fields


def check_repl_tables(tables):
    """Phase 2b: K2's replication flags, derived on the card from each
    mode's 1080p masks (``ops.blockreduce.replication_flags``), equal the
    table the engine reads (``PlaneTables.repl``), which is built on the
    host with the other tables and moved to the card as it is."""
    import torch

    from vvc_affine_tpu_torch.ops import blockreduce as br

    for mode, t in tables.items():
        got = br.replication_flags(t.border_packed)
        torch.cuda.synchronize()
        _require(t.repl.device == got.device and t.repl.dtype == got.dtype
                 and torch.equal(got, t.repl),
                 f"{mode}: the card's replication flags differ from the "
                 f"host table")
        print(f"[tables] {mode} {FW}x{FH}: replication flags on the card "
              f"== the host table ({tuple(t.repl.shape)}, "
              f"{int((t.repl != 0).sum())} blocks flagged)", flush=True)


def check_warp(tables, ref, rng):
    """Phase 3: K1 == warp_xla, bit for bit, on every field family.
    Returns per-mode arguments (the random field) for the timing phase and
    the largest error."""
    import torch

    from vvc_affine_tpu_torch.ops import warp as wp

    dev = ref.device
    out = {}
    for mode, t in tables.items():
        ones = torch.ones((t.n_ctus, t.n_bins, 16), dtype=torch.int32,
                          device=dev)
        shares = {}
        for name, (dy, dx, fx, fy) in _warp_fields(t, mode, rng,
                                                   dev).items():
            want = wp.warp_xla(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx,
                               wp.tap_planes(fx), wp.tap_planes(fy))
            got = wp.warp(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx, fx, fy,
                          ones)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want).abs().max())
            _require(err == 0, f"K1 {mode} {name}: max |err| {err}")
            shares[name] = _global_share(t, dy, dx, ones)
            if name.startswith("random"):
                # with the engine's slab mask: equal on every active slab
                got = wp.warp(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx, fx, fy,
                              t.slab_active)
                rows = t.slab_active.repeat_interleave(8, dim=-1).bool()
                err_act = int(((got.to(torch.int32) - want).abs()
                               * rows[..., None]).max())
                _require(err_act == 0, f"K1 {mode}: active slabs differ")
                out[mode] = dict(err=0,
                                 args=(ref, FW, FH, t.ctu_y, t.ctu_x, dy, dx,
                                       fx, fy, t.slab_active),
                                 act=float(t.slab_active.float().mean()))
        print(f"[K1] {mode}: bit-equal to warp_xla on {len(shares)} fields "
              f"({t.n_ctus}x{t.n_bins} planes); global-path share "
              f"{json.dumps({k: round(v, 4) for k, v in shares.items()})}",
              flush=True)
    return out


def _global_share(t, dy, dx, slab_active):
    """Share of K1's active blocks that read global memory (the staging
    rule of ``ops.warp.staging_plan``)."""
    from vvc_affine_tpu_torch.ops import warp as wp

    _, _, staged = wp.staging_plan(t.ctu_y, t.ctu_x, dy, dx)
    act = slab_active.repeat_interleave(2, dim=-1).bool()[..., None]
    act = act.expand_as(staged)
    return float((~staged & act).sum()) / max(1, int(act.sum()))


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
                pred, orig_pl, t.border_packed, refine, t.repl)
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
                out[mode] = dict(err=err, args=(pred, orig_pl,
                                                t.border_packed, True, t.repl))
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
            fn = ap.build_pair_stage(*specs, device=d)
            # on the card: the warm-up (eager) call, then a graph replay
            for _ in range(1 if d else 2):
                outs.append([o.cpu() for o in fn(*args)])
        for card in outs[:-1]:
            for name, a, b in zip(("cost2", "cpmvs2", "cost3", "cpmvs3"),
                                  card, outs[-1]):
                _require(a.dtype == b.dtype and torch.equal(a, b),
                         f"{mode} {name}: card differs from CPU")
        print(f"[stage] {mode} pair at {SMALL_W}x{SMALL_H}: card (warm-up "
              f"and replay) == CPU (costs int64, CPMVs int32)", flush=True)


def _mv_cpmvs(t, kind, rng):
    """Phase 5b's CPMVs int32 [nCtu, nCU, 3, 2] on the tables' device:
    random (|v| <= 3000), at +-MV_MAX, RT and LB far enough from LT that
    every CU's sub-block spread is over the limit, zero, those four mixed
    per CU, or the zoom and rotation of ``_cpmv_field``."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import constants as C

    if kind in ("zoom", "rotation"):
        return _cpmv_field(t, None, kind)
    shape = (t.n_ctus, t.n_cus, 3, 2)

    def one(kind):
        if kind == "random":
            return rng.integers(-3000, 3001, size=shape)
        if kind == "mv_max":
            return rng.choice([C.MV_MIN, C.MV_MAX, -C.MV_MAX], size=shape)
        if kind == "spread":
            lt = rng.integers(-500, 501, size=shape[:2] + (1, 2))
            cp = lt + (rng.integers(2000, 8000, size=shape)
                       * rng.choice([-1, 1], size=shape))
            cp[:, :, 0] = lt[:, :, 0]
            return cp
        return np.zeros(shape, np.int64)

    if kind == "mixed":
        cp = np.choose(rng.integers(0, 4, size=shape[:2])[..., None, None],
                       [one(k) for k in MV_KINDS[:4]])
    else:
        cp = one(kind)
    return torch.as_tensor(np.clip(cp, C.MV_MIN, C.MV_MAX).astype(np.int32),
                           device=t.within.device)


def _mv_cost(t):
    """Bytes and operations the motion-plane kernel needs for one call: the
    four int32 planes out; the CUs' CPMVs, corners and in-frame flags and
    the block table in, once; about 60 integer operations per block."""
    n = t.n_ctus * t.n_bins * 1024
    nbytes = (n * 16 + t.n_ctus * t.n_cus * (24 + 4 + 4 + 1)
              + t.mv_slots.numel() * 4)
    return nbytes, n * 60


def check_mvplanes():
    """Phase 5b: the motion-plane kernel (``csrc/mvplanes.cu``).  (a) At
    1920x1080 and 3840x2160, FULL and HALF, 2CP and 3CP, on every kind of
    ``_mv_cpmvs``: ``affine_plane._mv_planes`` (one kernel launch) equals
    its plain version ``_mv_planes_plain`` run on the card, bit for bit;
    and on the 4K tables padded to 512 CTUs, whole and as the last shard's
    ``ctu_rows``.  (b) Per (size, mode, n_cp) the kernel's time (bare
    launches, CUDA events) beside its bytes bound and the plain version's
    time.  (c) Per mode at 1080p, a new captured pair (``Graphed`` around
    ``eager_pair_fn``) and its replay on phase 6b's first input set: 10
    K1, 11 K2 and 10 motion-plane launches per replay, outputs bit-identical
    to the eager oracle's and to the eager pair with the plain motion
    planes; the captured graphs' nodes (``runtime.graphs.count_nodes``)
    per pair and per frame-ref.  Prints a ``mvplanes`` JSON line and
    returns the kernel's row of the ``kernels`` line (its ``launches``
    filled in by phase 6)."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.ops import mvplanes as mvp
    from vvc_affine_tpu_torch.runtime import graphs

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(515)
    timed = []
    for w, h in ((FW, FH), (3840, 2160)):
        for mode in ("full", "half"):
            t = ap.build_tables(ap.PlaneSpec(mode, 2, w, h), dev)
            tp = ap.build_tables(ap.PlaneSpec(mode, 2, w, h), dev, 512)
            layouts = {"": t}
            if w == 3840:
                layouts.update({" padded": tp,
                                " last shard": ap.ctu_rows(tp, 384, 512)})
            for n_cp in (2, 3):
                spec = ap.PlaneSpec(mode, n_cp, w, h)
                for name, tt in layouts.items():
                    for kind in MV_KINDS if not name else ("mixed",):
                        cp = _mv_cpmvs(tt, kind, rng)
                        kernels.reset_launches()
                        got = ap._mv_planes(spec, tt, cp)
                        torch.cuda.synchronize()
                        _require(kernels.launches["mvplanes"] == 1,
                                 f"mvplanes launched {kernels.launches}")
                        want = ap._mv_planes_plain(spec, tt, cp)
                        _require(all(
                            g.dtype == v.dtype and torch.equal(g, v)
                            for g, v in zip(got, want, strict=True)),
                            f"mvplanes {w}x{h} {mode} {n_cp}CP{name} "
                            f"{kind}: kernel differs from the plain version")
                cp = _mv_cpmvs(t, "random", rng)
                planes, run = mvp.bind_mv_planes(
                    cp, t.abs_x, t.abs_y, t.within, t.mv_slots, n_cp, w, h)
                bound_ms, bound_by = _bound(*_mv_cost(t))
                timed.append({
                    "frame": f"{w}x{h}", "mode": mode, "n_cp": n_cp,
                    "planes": f"{t.n_ctus} CTUs x {t.n_bins} bins",
                    "ms": _median_ms(run, 5, 20), "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "plain_ms": _median_ms(lambda: ap._mv_planes_plain(
                        spec, t, cp), 3, 2)})
                del planes, run
            print(f"[mvplanes] {w}x{h} {mode}: kernel == plain on "
                  f"{len(MV_KINDS)} kinds x 2CP/3CP"
                  f"{', padded and last shard' if w == 3840 else ''}",
                  flush=True)
            del t, tp, layouts
        torch.cuda.empty_cache()
    args0 = _graph_inputs()[0]
    nodes, one = {}, _path_launches(
        {k: v // 2 for k, v in PAIR_LAUNCHES.items()})
    for mode in ("full", "half"):
        s2, s3 = (ap.PlaneSpec(mode, n, FW, FH) for n in (2, 3))
        eager = ap.eager_pair_fn(s2, s3, dev)
        pair = graphs.Graphed(eager, dev, eager.check)
        args = args0[mode]
        pair(*args)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = pair(*args)
        torch.cuda.synchronize()
        _require(kernels.launches == one, f"{mode} pair replay launched "
                                          f"{kernels.launches}, want {one}")
        _same_outputs(f"{mode} pair (mvplanes kernel)", got, eager(*args))
        saved = ap._mv_planes
        ap._mv_planes = ap._mv_planes_plain
        try:
            plain = eager(*args)
        finally:
            ap._mv_planes = saved
        _same_outputs(f"{mode} pair with the plain motion planes", got, plain)
        nodes[mode] = graphs.count_nodes(pair.graph)
        del pair, got, plain
    line = {"kernel": "mvplanes", "times": timed,
            "nodes_per_pair": nodes,
            "nodes_per_frame_ref": sum(n["total"] for n in nodes.values()),
            "launches_per_pair_replay": one["mvplanes"],
            **kernels.attributes("mvplanes")}
    print(json.dumps({"mvplanes": line}), flush=True)
    full = [r for r in timed if r["frame"] == f"{FW}x{FH}"
            and r["mode"] == "full"]
    return {"name": "mvplanes", "route": "cuda",
            "source": "vvc_affine_tpu_torch/csrc/mvplanes.cu",
            "replaces": None, "launches": None, "max_abs_err": 0,
            **{k: sum(r[k] for r in full) / len(full)
               for k in ("ms", "bound_ms", "plain_ms")},
            "bound_by": full[0]["bound_by"], "library_ms": None,
            **kernels.attributes("mvplanes"),
            "shape": f"1080p full: {full[0]['planes']}, mean of 2CP and 3CP"}


def _fold_k2(spec, t, ref_flat, orig_pl, ref_pl, kind, rng):
    """K2's outputs (satd_b, moms_b) that the engine folds per CU, on the
    card: of ``_evaluate_zero`` (kind "zero"), of ``_evaluate`` under
    ``_mv_cpmvs`` of the kind, or random at their extremes ("extremes":
    SATD over the int32 range and at both ends, moments over and at
    +-2^29)."""
    import torch

    from vvc_affine_tpu_torch.models import affine_plane as ap

    dev = t.within.device
    if kind == "extremes":
        shape = (t.n_ctus, t.n_bins, 32, 32)
        g = torch.Generator(device=dev)
        g.manual_seed(int(rng.integers(2**31)))
        satd = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             device=dev, dtype=torch.int32)
        moms = torch.randint(-2**29, 2**29 + 1, shape[:2] + (5,) + shape[2:],
                             generator=g, device=dev, dtype=torch.int32)
        for x, lo, hi in ((satd, -2**31, 2**31 - 1), (moms, -2**29, 2**29)):
            pick = torch.rand(x.shape, generator=g, device=dev)
            x[pick < 0.2] = hi
            x[pick > 0.8] = lo
        return satd, moms
    seen = []
    saved = ap._fold_cu
    ap._fold_cu = lambda *a: seen.append(a[2:4]) or (None, None, None)
    try:
        if kind == "zero":
            ap._evaluate_zero(spec, t, ref_pl, orig_pl, True)
        else:
            ap._evaluate(spec, t, ref_flat, orig_pl,
                         _mv_cpmvs(t, kind, rng), True)
    finally:
        ap._fold_cu = saved
    return seen[0]


def _fold_cost(t, n_cp, refine):
    """Bytes and operations the CU fold needs for one call: the SATD (and
    five moments) of every slot of an in-frame CU in, once; the lane table
    and the block table's rows in, once; the per-CU outputs out; about 25
    multiply-adds (2 operations each) per slot with the moments, 1
    without."""
    slots = int((t.within * (t.cu_w // 4 * t.cu_h // 4)).sum())
    pn = 2 * n_cp
    per_cu = 8 * (1 + (pn * pn + pn) * refine)
    nbytes = (slots * 4 * (6 if refine else 1)
              + t.n_ctus * t.n_cus * per_cu + t.fold_lanes.numel() * 4
              + t.mv_slots[0].numel() * 4 * (3 if refine else 1))
    return nbytes, slots * (50 if refine else 2)


def check_cufold():
    """Phase 5c: the CU fold kernel (``csrc/cufold.cu``).  (a) At 1920x1080
    and 3840x2160, FULL and HALF, on ``mebench/frames.py`` content: for K2's
    outputs under zero, random, zoom and rotation CPMVs and random K2
    outputs at their extremes, ``affine_plane._fold_cu`` (one kernel
    launch) equals its plain version ``_fold_cu_plain`` run on the card,
    bit for bit, for 2CP and 3CP with the equations and for SATD only; and
    on the 4K tables padded to 512 CTUs, whole and as the last shard's
    ``ctu_rows``.  (b) Per (size, mode, n_cp / SATD only) the kernel's time
    (bare launches, CUDA events) beside its bytes bound and the plain
    version's time.  (c) Per mode at 1080p, a new captured pair (``Graphed``
    around ``eager_pair_fn``) and its replay on phase 6b's first input set:
    11 CU fold launches per replay, outputs bit-identical to the eager
    oracle's and to the eager pair with the plain fold; the captured
    graphs' nodes per pair and per frame-ref.  Prints a ``cufold`` JSON
    line and returns the kernel's row of the ``kernels`` line (its
    ``launches`` filled in by phase 6)."""
    import numpy as np
    import torch

    from mebench import frames as mframes
    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.ops import cufold
    from vvc_affine_tpu_torch.runtime import graphs

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(517)
    cases = ((2, True), (3, True), (2, False))
    timed = []
    for w, h in ((FW, FH), (3840, 2160)):
        orig, recon = mframes.affine_gop(w, h, 1, mframes.Draws(517 + w, dev))
        ref_flat = recon[0].reshape(-1).to(torch.int32)
        orig_flat = orig[0].reshape(-1).to(torch.int32)
        del orig, recon
        for mode in ("full", "half"):
            s2 = ap.PlaneSpec(mode, 2, w, h)
            t = ap.build_tables(s2, dev)
            layouts = {"": (t, t, None)}
            if w == 3840:
                tp = ap.build_tables(s2, dev, 512)
                layouts.update({
                    " padded": (tp, tp, None),
                    " last shard": (tp, ap.ctu_rows(tp, 384, 512),
                                    slice(384, 512))})
            for name, (base, tt, rows) in layouts.items():
                orig_pl, ref_pl = ap.prep_inputs(s2, base, ref_flat,
                                                 orig_flat)
                kinds = ("zero", "random", "zoom", "rotation", "extremes")
                for kind in kinds if not name else ("zoom", "extremes"):
                    satd_b, moms_b = _fold_k2(s2, base, ref_flat, orig_pl,
                                              ref_pl, kind, rng)
                    if rows is not None:
                        satd_b, moms_b = satd_b[rows], moms_b[rows]
                    for n_cp, refine in cases:
                        spec = ap.PlaneSpec(mode, n_cp, w, h)
                        mb = moms_b if refine else None
                        kernels.reset_launches()
                        got = ap._fold_cu(spec, tt, satd_b, mb, refine)
                        torch.cuda.synchronize()
                        _require(kernels.launches["cufold"] == 1,
                                 f"cufold launched {kernels.launches}")
                        want = ap._fold_cu_plain(spec, tt, satd_b, mb,
                                                 refine)
                        _require(all(
                            (g is None and v is None) or (
                                g.dtype == v.dtype and torch.equal(g, v))
                            for g, v in zip(got, want, strict=True)),
                            f"cufold {w}x{h} {mode} {n_cp}CP refine "
                            f"{refine}{name} {kind}: kernel differs from "
                            f"the plain version")
                    del satd_b, moms_b, got, want
                del orig_pl, ref_pl
            # times on the zoom field's K2 outputs
            orig_pl, ref_pl = ap.prep_inputs(s2, t, ref_flat, orig_flat)
            satd_b, moms_b = _fold_k2(s2, t, ref_flat, orig_pl, ref_pl,
                                      "zoom", rng)
            for n_cp, refine in cases:
                spec = ap.PlaneSpec(mode, n_cp, w, h)
                mb = moms_b if refine else None
                out, run = cufold.bind_fold_cu(satd_b, mb, t.within,
                                               t.fold_lanes, t.mv_slots,
                                               n_cp, refine)
                bound_ms, bound_by = _bound(*_fold_cost(t, n_cp, refine))
                timed.append({
                    "frame": f"{w}x{h}", "mode": mode,
                    "n_cp": n_cp if refine else None, "refine": refine,
                    "ctus": t.n_ctus, "ms": _median_ms(run, 5, 20),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "plain_ms": _median_ms(lambda: ap._fold_cu_plain(
                        spec, t, satd_b, mb, refine), 3, 2)})
                del out, run
            print(f"[cufold] {w}x{h} {mode}: kernel == plain on 5 kinds x "
                  f"2CP/3CP/SATD only"
                  f"{', padded and last shard' if w == 3840 else ''}",
                  flush=True)
            del t, layouts, orig_pl, ref_pl, satd_b, moms_b
            if w == 3840:
                del tp
        torch.cuda.empty_cache()
    args0 = _graph_inputs()[0]
    nodes, one = {}, _path_launches(
        {k: v // 2 for k, v in PAIR_LAUNCHES.items()})
    for mode in ("full", "half"):
        s2, s3 = (ap.PlaneSpec(mode, n, FW, FH) for n in (2, 3))
        eager = ap.eager_pair_fn(s2, s3, dev)
        pair = graphs.Graphed(eager, dev, eager.check)
        args = args0[mode]
        pair(*args)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = pair(*args)
        torch.cuda.synchronize()
        _require(kernels.launches == one, f"{mode} pair replay launched "
                                          f"{kernels.launches}, want {one}")
        _same_outputs(f"{mode} pair (cufold kernel)", got, eager(*args))
        saved = ap._fold_cu
        ap._fold_cu = ap._fold_cu_plain
        try:
            plain = eager(*args)
        finally:
            ap._fold_cu = saved
        _same_outputs(f"{mode} pair with the plain fold", got, plain)
        nodes[mode] = graphs.count_nodes(pair.graph)
        del pair, got, plain
    line = {"kernel": "cufold", "times": timed,
            "nodes_per_pair": nodes,
            "nodes_per_frame_ref": sum(n["total"] for n in nodes.values()),
            "launches_per_pair_replay": one["cufold"],
            **kernels.attributes("cufold")}
    print(json.dumps({"cufold": line}), flush=True)
    full = [r for r in timed if r["frame"] == f"{FW}x{FH}"
            and r["mode"] == "full" and r["refine"]]
    return {"name": "cufold", "route": "cuda",
            "source": "vvc_affine_tpu_torch/csrc/cufold.cu",
            "replaces": None, "launches": None, "max_abs_err": 0,
            **{k: sum(r[k] for r in full) / len(full)
               for k in ("ms", "bound_ms", "plain_ms")},
            "bound_by": full[0]["bound_by"], "library_ms": None,
            **kernels.attributes("cufold"),
            "shape": f"1080p full: {full[0]['ctus']} CTUs, mean of 2CP and "
                     f"3CP with the equations"}


def _log_bytes(prefix):
    """name (without the prefix) -> bytes of every decision log"""
    from vvc_affine_tpu_torch.runtime import reporting

    out = {}
    for pred in range(4):
        for path in reporting.log_paths(prefix, pred):
            with open(path, "rb") as f:
                out[path[len(prefix):]] = f.read()
    return out


def run_main_path(n_ctu, tmp):
    """Phase 6: the CLI at 1080p, with its CSVs and logs in ``tmp``.  The
    process's first 1080p run: its first frame-ref warms up and captures
    the pair graphs, the other two replay them.  Returns the launch counts
    of the run, the two CSV paths, the bytes of every decision log, the
    seconds per frame-ref and the run's device memory (bytes allocated at
    its start and end, its peaks)."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import cli, kernels, testing
    from vvc_affine_tpu_torch.runtime import frames as frames_io
    from vvc_affine_tpu_torch.runtime import reporting
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    orig_g, recon_g = testing.affine_gop(FW, FH, 2, seed=0)
    opath, rpath = (os.path.join(tmp, f) for f in ("orig.csv", "ref.csv"))
    frames_io.write_frames_csv(opath, orig_g)
    frames_io.write_frames_csv(rpath, recon_g)
    prefix = os.path.join(tmp, "log")
    torch.cuda.synchronize()
    memory = {"start_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-f", "2", "-s", f"{FW}x{FH}", "-q", "32",
                       "-o", opath, "-r", rpath, "-l", prefix])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    memory.update(peak_bytes=torch.cuda.max_memory_allocated(),
                  peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                  end_bytes=torch.cuda.memory_allocated())
    launches = dict(kernels.launches)
    _require(rc == 0, f"cli.main returned {rc}")
    _require(launches == _path_launches(
        {k: 3 * v for k, v in PAIR_LAUNCHES.items()}),
             f"main path launches {launches}, want warp 60, "
             f"blockreduce 66, mvplanes 60 and cufold 66")
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
    per_ref = frame_ref_s(buf.getvalue().splitlines())
    _require(len(per_ref) == 3, f"timed frame-refs {per_ref}")
    print(json.dumps({"main_path": {"cli_s": cli_s, "launches": launches,
                                    "log_rows": n_rows,
                                    "frame_ref_s": per_ref,
                                    "memory": memory}}),
          flush=True)
    return launches, (opath, rpath), _log_bytes(prefix), per_ref, memory


def _graph_inputs():
    """Four 1080p stage input sets on the card, each different: frame pairs
    of ``affine_gop(seed=4)`` at their POC's lambda (QP 32), zero CPMVs."""
    from vvc_affine_tpu_torch import constants as C
    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.models import affine_plane as ap

    orig, recon = testing.affine_gop(FW, FH, 3, seed=4)
    z = ap.zero_cpmvs(ap.PlaneSpec("full", 2, FW, FH), "cpu")
    zh = ap.zero_cpmvs(ap.PlaneSpec("half", 2, FW, FH), "cpu")
    out = []
    for o, r, poc in ((0, 0, 1), (1, 1, 2), (1, 0, 2), (2, 2, 3)):
        args = ap.stage_inputs_from_numpy(recon[r], orig[o],
                                          C.lambda_for(32, poc), z, None)
        out.append({"full": args, "half": (*args[:3], zh.cuda())})
    return out


def _same_outputs(name, got, want):
    import torch

    _require(len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        for g, w in zip(got, want)), f"{name}: graph differs from eager")


def check_graphs():
    """Phase 6b(a): per mode at 1920x1080, one new captured pair
    (``runtime.graphs.Graphed`` around ``affine_plane.eager_pair_fn``) fed
    four input sets in turn (the first call warms up and captures, three
    replay), each output bit-identical to the eager pair's on the same set,
    every call launching the eager pair's 10 K1 and 11 K2; all four calls'
    outputs checked again at the end (an output aliasing the graph's own
    would have been overwritten).  Then ``build_stage``'s 2CP and 3CP
    stages the same way, 3CP on the 2CP CPMVs of each set.  Returns the
    capture seconds per mode."""
    import torch

    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.runtime import graphs

    dev = torch.device("cuda:0")
    sets = _graph_inputs()
    one = _path_launches({k: v // 2 for k, v in PAIR_LAUNCHES.items()})
    capture_s = {}
    for mode in ("full", "half"):
        s2, s3 = (ap.PlaneSpec(mode, n, FW, FH) for n in (2, 3))
        eager = ap.eager_pair_fn(s2, s3, dev)
        pair = graphs.Graphed(eager, dev, eager.check)
        stages = {n: (ap.eager_stage_fn(s, dev),
                      graphs.Graphed(ap.eager_stage_fn(s, dev), dev))
                  for n, s in ((2, s2), (3, s3))}
        kept = []
        for i, inputs in enumerate(sets):
            args = inputs[mode]
            counts = []
            for fn in (pair, eager):
                torch.cuda.synchronize()
                kernels.reset_launches()
                out = fn(*args)
                torch.cuda.synchronize()
                counts.append(dict(kernels.launches))
                kept.append(out)
            _require(counts == [one, one], f"{mode} set {i}: launches "
                     f"{counts}, want {one} per call")
            _same_outputs(f"{mode} pair, set {i}", *kept[-2:])
            prev = args[3]
            for n in (2, 3):
                e, g = stages[n]
                want = e(*args[:3], prev)
                _same_outputs(f"{mode} {n}CP stage, set {i}",
                              g(*args[:3], prev), want)
                prev = want[1]
        for i in range(len(sets)):
            _same_outputs(f"{mode} pair, set {i}, kept",
                          *kept[2 * i:2 * i + 2])
        _require(pair.replays == 3 and stages[3][1].replays == 3,
                 f"{mode}: {pair.replays} pair replays, want 3")
        capture_s[mode] = {"pair": pair.capture_s,
                           "2cp": stages[2][1].capture_s,
                           "3cp": stages[3][1].capture_s}
        print(f"[graph] {mode} 1920x1080: 4 input sets, 3 replays, pair and "
              f"2CP/3CP stages bit-identical to the eager loop; capture "
              f"{pair.capture_s:.3f} s (pair)", flush=True)
    return capture_s


def _path_launches(counts):
    """Every kernel's launch count for a path that launches ``counts``."""
    from vvc_affine_tpu_torch import kernels

    return {**dict.fromkeys(kernels.launches, 0), **counts}


def _warp_cost(t, act):
    """Bytes and operations K1 needs for one call on this run's data: the
    frame once, the CTU corners and slab mask, and on active slabs the four
    int32 motion planes in and the int16 planes out; per 4x4 block,
    9x4x6 + 4x4x6 multiply-adds of the separable filter (2 ops each)."""
    n = t.n_ctus * t.n_bins
    nbytes = (FW * FH * 4 + 2 * t.n_ctus * 4 + n * 16 * 4
              + act * n * (4 * 1024 * 4 + 16384 * 2))
    return nbytes, act * n * 1024 * 2 * (9 * 4 * 6 + 4 * 4 * 6)


def _blockreduce_cost(n_ctu, n_bins, pred_bins, refine):
    """Bytes and operations K2 needs: the int16 planes, the int32 original
    CTUs and the per-block replication flags in; SATD (and five moments)
    out.  Per sample about 12 integer operations for the SATD (difference,
    butterflies, abs, sum) and, with moments, 38 more: Sobel 2 x 12,
    replication selects ~4, products and sums 10."""
    n = n_ctu * n_bins
    nbytes = (n_ctu * pred_bins * 16384 * 2 + n_ctu * 16384 * 4
              + n_bins * 1024 + n * 1024 * 4 * (6 if refine else 1))
    return nbytes, n * 16384 * (50 if refine else 12)


def _bound(nbytes, ops):
    """(bound_ms, bound_by) at the data-sheet rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _path_inputs(mode):
    """The main path's first 1080p stage inputs: ``affine_gop`` seed 0, POC
    1 against the POC 0 reconstruction at QP 32, zero 2CP CPMVs, on the
    default device."""
    from vvc_affine_tpu_torch import constants as C
    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.models import affine_plane as ap

    orig, recon = testing.affine_gop(FW, FH, 2, seed=0)
    z = ap.zero_cpmvs(ap.PlaneSpec(mode, 2, FW, FH), "cpu")
    return ap.stage_inputs_from_numpy(recon[0], orig[0], C.lambda_for(32, 1),
                                      z, None)


def _path_pair(mode, eager=False):
    """The main path's first 1080p pair of one mode (``_path_inputs``): the
    pair as the main path runs it (a CUDA graph) or, with ``eager``, its
    eager loop (``affine_plane.eager_pair_fn``).  Returns (fn, args)."""
    import torch

    from vvc_affine_tpu_torch.models import affine_plane as ap

    specs = (ap.PlaneSpec(mode, 2, FW, FH), ap.PlaneSpec(mode, 3, FW, FH))
    if eager:
        return (ap.eager_pair_fn(*specs, torch.device("cuda:0")),
                _path_inputs(mode))
    return ap.build_pair_stage(*specs), _path_inputs(mode)


def capture_path_launches():
    """The arguments of every K1 and K2 launch of one 1080p pair per mode
    on the main path's content, captured by wrapping the two bind
    functions for the length of the pair.  The eager pair: a graph's
    capture binds its launches with inputs that hold no data yet.  Returns
    {(mode, kernel): [args, ...]} with every tensor argument cloned."""
    import torch

    from vvc_affine_tpu_torch.ops import blockreduce as br
    from vvc_affine_tpu_torch.ops import warp as wp

    def keep(args):
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    path = {}
    binds = {"warp": (wp, "bind_warp"),
             "blockreduce": (br, "bind_reduce_blocks")}
    for mode in ("full", "half"):
        fn, args = _path_pair(mode, eager=True)
        saved = {k: getattr(mod, name) for k, (mod, name) in binds.items()}
        for k, (mod, name) in binds.items():
            path[mode, k] = []
            setattr(mod, name, lambda *a, k=k: (path[mode, k].append(keep(a)),
                                                saved[k](*a))[1])
        try:
            fn(*args)
            torch.cuda.synchronize()
        finally:
            for k, (mod, name) in binds.items():
                setattr(mod, name, saved[k])
        _require(len(path[mode, "warp"]) == PAIR_LAUNCHES["warp"] // 2
                 and len(path[mode, "blockreduce"])
                 == PAIR_LAUNCHES["blockreduce"] // 2,
                 f"{mode} pair: {len(path[mode, 'warp'])} K1 and "
                 f"{len(path[mode, 'blockreduce'])} K2 launches")
    return path


def _path_bound(tables, mode, name, a):
    """bound_ms of one captured launch, on its own inputs."""
    t = tables[mode]
    if name == "warp":
        return _bound(*_warp_cost(t, float(a[9].float().mean())))[0]
    pred, _, repl, refine = a
    return _bound(*_blockreduce_cost(pred.shape[0], repl.shape[0],
                                     pred.shape[1], refine))[0]


def _path_runner(name, a, other=None, masks=None):
    """A launcher of one captured launch and its outputs, bound once: the
    port's kernel, or with ``other`` the kernel built from the source in
    that directory (``kernels.source_dir``).  ``masks``: that K2 takes the
    int32 per-sample border masks, as the first K2 design (commit 1852060)
    did, in place of the per-block flags."""
    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.ops import blockreduce as br
    from vvc_affine_tpu_torch.ops import warp as wp

    bind = wp.bind_warp if name == "warp" else br.bind_reduce_blocks
    if other is None:
        *outs, run = bind(*a)
        return run, outs
    with kernels.source_dir(other):
        *outs, run = bind(*a)
        if masks is not None:
            pred, orig, repl, _ = a
            run = kernels.bind("blockreduce", pred.device, *outs, pred, orig,
                               masks, pred.shape[0], repl.shape[0],
                               pred.shape[1])
    return run, outs


def _path_ms(name, launches, other=None, masks=None):
    """Launch-weighted mean ms of a kernel over the captured launches."""
    times = []
    for a in launches:
        run, _ = _path_runner(name, a, other, masks)
        times.append(_median_ms(run, 5, 20))
    return sum(times) / len(times), times


def time_kernels(tables, warp_stats, br_stats, launches, path):
    """Phase 7: kernel and plain-version times at the 1080p shapes.

    ``ms`` times the bare launches of a kernel bound once to its inputs and
    preallocated outputs, back to back, so the device queue never drains:
    the kernel's own time, on the random fields of phases 3-4.  ``ms_path``
    times the same way each launch that one 1080p pair of the main path
    made (``capture_path_launches``) and takes their mean, beside
    ``bound_path_ms``, the mean of those launches' bounds.  ``wrapper_ms``
    times the whole wrapper (input checks, output allocation, binding) as
    the engine calls it.  Returns the FULL rows and, per (mode, kernel),
    the bound launcher for phase 8.
    """
    from vvc_affine_tpu_torch import kernels
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
        bound[mode, "blockreduce"] = br.bind_reduce_blocks(b[0], b[1], b[4],
                                                           b[3])
        for name, fn, plain_fn, cost, err in (
                ("warp", lambda a=a: wp.warp(*a), plain,
                 _warp_cost(t, warp_stats[mode]["act"]),
                 warp_stats[mode]["err"]),
                ("blockreduce", lambda b=b: br.reduce_blocks(*b),
                 lambda b=b: br.reduce_blocks_plain(*b[:4]),
                 _blockreduce_cost(t.n_ctus, t.n_bins, t.n_bins, True),
                 br_stats[mode]["err"])):
            bound_ms, bound_by = _bound(*cost)
            ms_path, per_launch = _path_ms(name, path[mode, name])
            bounds = [_path_bound(tables, mode, name, x)
                      for x in path[mode, name]]
            row = {
                "name": name, "route": "cuda",
                "source": f"vvc_affine_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err,
                "ms": _median_ms(bound[mode, name][-1], 5, 20),
                "wrapper_ms": _median_ms(fn),
                "plain_ms": _median_ms(plain_fn, 3, 2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "ms_path": ms_path,
                "bound_path_ms": sum(bounds) / len(bounds),
                **kernels.attributes(name),
                "shape": f"1080p {mode}: {t.n_ctus} CTUs x {t.n_bins} bins"}
            per = {"kernel": name, "mode": mode, "ms": per_launch,
                   "bound_ms": bounds}
            if name == "warp":
                per["global_path_share"] = [
                    _global_share(t, x[5], x[6], x[9])
                    for x in path[mode, name]]
                row["global_path_share"] = (sum(per["global_path_share"])
                                            / len(path[mode, name]))
            else:
                per["pred_bins"] = [x[0].shape[1] for x in path[mode, name]]
                per["refine"] = [x[3] for x in path[mode, name]]
            print(f"[path] {json.dumps(per)}", flush=True)
            if mode == "full":
                rows.append(row)
            else:
                print(f"[time] {json.dumps(row)}", flush=True)
    return rows, bound


def ab_compare(src_dir, path, tables, k2_masks):
    """--ab: this tree's K1 and K2 against the ``warp.cu`` and
    ``blockreduce.cu`` in ``src_dir`` on the captured main-path launches,
    each output first checked equal, then timed in turns (other, this,
    this, other).  ``k2_masks``: the K2 there takes the border masks."""
    import torch

    from vvc_affine_tpu_torch import kernels

    names = [n for n in ("warp", "blockreduce")
             if os.path.exists(os.path.join(src_dir, f"{n}.cu"))]
    _require(names, f"--ab: no warp.cu or blockreduce.cu in {src_dir}")
    before = dict(kernels.build_log)
    with kernels.source_dir(src_dir):
        kernels.build(tuple(f"{n}.cu" for n in names))
    for src, log in sorted(kernels.build_log.items()):
        for line in log.splitlines() if log != before.get(src) else ():
            if "registers" in line or "spill" in line:
                print(f"[ab] {os.path.relpath(src)}: {line.strip()}",
                      flush=True)
    for mode in ("full", "half"):
        for name in names:
            masks = (tables[mode].border_packed
                     if name == "blockreduce" and k2_masks else None)
            for a in path[mode, name]:
                got_run, got = _path_runner(name, a)
                ref_run, ref = _path_runner(name, a, src_dir, masks)
                got_run()
                ref_run()
                torch.cuda.synchronize()
                if name == "warp":      # rows of inactive slabs unspecified
                    rows = a[9].repeat_interleave(8, dim=-1).bool()[..., None]
                    got, ref = [got[0] * rows], [ref[0] * rows]
                for g, r in zip(got, ref):
                    _require((g is None and r is None) or torch.equal(g, r),
                             f"--ab {src_dir} {name} {mode}: outputs differ")
            turns = [_path_ms(name, path[mode, name], *who)[0]
                     for who in ((src_dir, masks), (), (), (src_dir, masks))]
            print("[ab] " + json.dumps({
                "mode": mode, "kernel": name,
                "other": os.path.join(src_dir, f"{name}.cu"),
                "turns_other_this_this_other_ms": turns}), flush=True)


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
    main path's content (``_path_pair``: the main path's first pair), as a
    graph replay and as the eager loop: the pair's CUDA-event time under
    the profiler, the device time of every kernel and copy in it, the
    device's idle share, and the two hand-written kernels' launches and
    device time per launch.  Returns {run: the busy share of one
    frame-ref (both modes' pairs)}."""
    share = {}
    for run in ("replayed", "eager"):
        busy = pair = 0.0
        for mode in ("full", "half"):
            row = {"mode": mode, "frame": f"{FW}x{FH}", "run": run,
                   **_profile_pair(*_path_pair(mode, run == "eager"))}
            busy += row["device_busy_ms"]
            pair += row["pair_ms"]
            print(f"[profile] {json.dumps(row)}", flush=True)
        share[run] = busy / pair
    return share


def _profile_pair(fn, args):
    """One warm call of the pair ``fn(*args)``, then one under the
    profiler: its CUDA-event ms, device busy ms and idle share, device
    launches, and K1/K2 launches and device ms per launch."""
    import torch

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
    row = {"pair_ms": pair_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / pair_ms,
           "device_launches": len(events)}
    for name in _KERNEL_SYMBOLS:
        row[f"{name}_launches"], row[f"{name}_ms_per_launch"] = (
            _kernel_ms(events, name))
    return row


def profile_pairs_4k():
    """Phase 13g: one 2CP->3CP pair per mode at 3840x2160 on gop_golden's
    first frame pair (POC 1 against POC 0, QP 32), in this process under
    the profiler (``_profile_pair``): K1/K2 device time per launch at 4K
    and the pair's idle share."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import constants as C
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.tools import gop_golden

    from vvc_affine_tpu_torch import kernels

    w, h = 3840, 2160
    origs, refs = gop_golden.gop(w, h, 1)
    out = {}
    for mode in ("full", "half"):
        s2, s3 = (ap.PlaneSpec(mode, n_cp, w, h) for n_cp in (2, 3))
        dev = torch.device("cuda:0")
        args = ap.stage_inputs_from_numpy(
            refs[0].astype(np.int32), origs[0].astype(np.int32),
            C.lambda_for(32, 1), ap.zero_cpmvs(s2, "cpu"), dev)
        kernels.reset_launches()
        row = _profile_pair(ap.build_pair_stage(s2, s3, dev), args)
        # two pairs ran (a warm one, a profiled one); the profiler's own
        # counts may miss events of a pair this long, so the wrappers'
        # counts are the check
        _require(kernels.launches == _path_launches(PAIR_LAUNCHES),
                 f"4K {mode}: two pairs launched {kernels.launches}")
        print("[profile] " + json.dumps(
            {"mode": mode, "frame": f"{w}x{h}", **row}), flush=True)
        out[mode] = row
        del args
    torch.cuda.empty_cache()
    return out


def _library_window(name, x, s):
    """One PyTorch expression on views of ``x`` that computes probe
    ``name``'s window at an in-range offset ``s`` (no wrap, no clamp): the
    yardstick ``library_ms``, never called by the port."""
    import torch

    if name == "k_b":
        return torch.roll(x[0:48, 0:128], s, 0)[0:8].to(torch.int32)
    if name == "k_c":
        return torch.roll(x[0:8], s, 1)[:, 0:128].to(torch.int32)
    row, lane = {"k_a": (8 * s, 0), "k_d_rows": (s, 0), "k_d_lanes": (0, s),
                 "k_e": (0, s)}[name]
    return x.narrow(0, row, 8).narrow(1, lane, 128).to(torch.int32)


def check_probes():
    """Phase 9: the probe tool's path, each probe kernel against its plain
    version and the numpy window, and the probe rows of the kernels line."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.tools import mosaic_probe as mp

    torch.cuda.synchronize()
    kernels.reset_launches()
    rc = mp.main([])
    torch.cuda.synchronize()
    path = dict(kernels.launches)
    _require(rc == 0, f"mosaic_probe.main returned {rc}")
    _require(path == _path_launches({f"probe_{n}": 1 for n in mp.PROBES}),
             f"probe path launches {path}, want each probe once")

    x_np = mp.tool_input()
    x = torch.as_tensor(x_np, device="cuda")
    errs = {}
    kernels.reset_launches()
    for name in mp.PROBES:
        err = 0
        for s in mp.CASES[name]:
            got = mp.probe(name, x, s)
            plain = mp.probe_plain(name, x, s)
            torch.cuda.synchronize()
            _require(got.dtype == torch.int32 and got.is_cuda
                     and tuple(got.shape) == mp.OUT_SHAPE,
                     f"{name} s={s}: {got.dtype} {tuple(got.shape)}")
            want = torch.as_tensor(mp.expected(name, x_np, s), device="cuda")
            err = max(err, int((got - plain).abs().max()),
                      int((got - want).abs().max()))
        _require(err == 0, f"{name}: max |err| {err} at offsets "
                           f"{mp.CASES[name]}")
        errs[name] = err
        print(f"[probe] {name}: bit-equal to probe_plain and numpy at s in "
              f"{mp.CASES[name]}", flush=True)
    _require(dict(kernels.launches) == _path_launches(
        {f"probe_{n}": len(mp.CASES[n]) for n in mp.PROBES}),
             f"comparison launches {kernels.launches}")

    # the floor under every probe's ms: an empty block of the probes' shape,
    # bound and launched the same way
    empty_ms = _median_ms(kernels.bind("empty_launch", x.device), 5, 20)
    print(f"[time] {json.dumps({'empty_launch_ms': empty_ms})}", flush=True)
    # the window read once (int16) and written once (int32), and the offset
    nbytes = 8 * 128 * 2 + 8 * 128 * 4 + 4
    rows = []
    for name, (_, s) in mp.PROBES.items():
        out, run = mp.bind_probe(name, x, s)
        lib = _library_window(name, x, s)
        run()
        torch.cuda.synchronize()
        _require(torch.equal(out, lib), f"{name}: library window differs")
        rows.append({
            "name": f"probe_{name}", "route": "cuda",
            "source": "vvc_affine_tpu_torch/csrc/window_probe.cu",
            "replaces": REPLACES[f"probe_{name}"],
            "launches": path[f"probe_{name}"], "max_abs_err": errs[name],
            "ms": _median_ms(run, 5, 20),
            "plain_ms": _median_ms(lambda n=name, s=s: mp.probe_plain(n, x, s)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": _median_ms(lambda n=name, s=s: _library_window(
                n, x, s)),
            "shape": f"x int16 [176, 256] -> int32 [8, 128], s = {s}"})
    return rows


def _read_trace(path):
    with open(path) as f:
        lines = f.read().splitlines()
    rows = [(float(t), int(b), int(p)) for t, b, p in
            (ln.split(",") for ln in lines[1:])]
    return lines[0], rows


def run_single_card_flags():
    """Phase 10: --CheckpointDir, --DeviceTrace and --MemoryReport through
    ``cli.main`` on the card at 416x240, -f 2."""
    import torch

    from vvc_affine_tpu_torch import cli, kernels, testing
    from vvc_affine_tpu_torch.runtime import frames as frames_io
    from vvc_affine_tpu_torch.runtime import reporting

    def drive(argv, frame_refs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        _require(rc == 0, f"cli.main {argv} returned {rc}")
        want = {k: frame_refs * v for k, v in PAIR_LAUNCHES.items()}
        _require(launches == _path_launches(want),
                 f"cli.main {argv}: launches {launches}, want {want}")
        return buf.getvalue(), want

    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        orig_g, recon_g = testing.affine_gop(SMALL_W, SMALL_H, 2, seed=1)
        opath, rpath = (os.path.join(tmp, f) for f in ("orig.csv", "ref.csv"))
        frames_io.write_frames_csv(opath, orig_g)
        frames_io.write_frames_csv(rpath, recon_g)
        base = ["-s", f"{SMALL_W}x{SMALL_H}", "-q", "32", "-o", opath,
                "-r", rpath]
        a, b = os.path.join(tmp, "x"), os.path.join(tmp, "y")
        _, summary["uninterrupted"] = drive(["-f", "2"] + base + ["-l", a], 3)

        ckpt = ["-l", b, "--CheckpointDir", os.path.join(tmp, "ckpt")]
        _, summary["checkpoint_f1"] = drive(["-f", "1"] + base + ckpt, 1)
        _, summary["resumed_f2"] = drive(["-f", "2"] + base + ckpt, 2)
        want, got = _log_bytes(a), _log_bytes(b)
        _require(len(want) == sum(len(reporting.log_paths("x", p))
                                  for p in range(4)), "missing logs")
        _require(got == want, "resumed run's logs differ from the "
                              "uninterrupted run's")
        summary["resumed_logs_identical"] = len(want)

        # earlier phases leave tensors allocated: the trace and the report
        # must show this run's own allocations above that baseline.  With
        # --PerPredTiming the four stages are graphs of their own, captured
        # here while the trace's thread reads the allocator
        trace = os.path.join(tmp, "trace.csv")
        c = os.path.join(tmp, "z")
        torch.cuda.synchronize()
        baseline = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, summary["trace_run"] = drive(
            ["-f", "2"] + base + ["-l", c, "--PerPredTiming", "--DeviceTrace",
                                  trace, "--MemoryReport"], 3)
        _require(_log_bytes(c) == want, "the --PerPredTiming run's logs "
                                        "differ from the uninterrupted run's")
        header, rows = _read_trace(trace)
        _require(header == "t_epoch,bytes_in_use,peak_bytes_in_use",
                 f"trace header {header!r}")
        _require(len(rows) > 0, "trace has no rows")
        in_use = {r[1] for r in rows}
        trace_peak = max(r[2] for r in rows)
        _require(len(in_use) > 1 and trace_peak > baseline,
                 f"trace: {len(rows)} rows, {len(in_use)} distinct "
                 f"bytes_in_use, peak {trace_peak} <= baseline {baseline}")
        report = dict(ln.rsplit(": ", 1) for ln in out.splitlines()
                      if ln.startswith("device ") and ": " in ln)
        dev_bytes = {k: int(report.get(k, "0")) for k in
                     ("device bytes_in_use", "device peak_bytes_in_use")}
        _require(dev_bytes["device bytes_in_use"] > 0
                 and dev_bytes["device peak_bytes_in_use"] > baseline,
                 f"memory report device lines {report}, baseline {baseline}")
        summary.update(baseline_bytes=baseline, trace_rows=len(rows),
                       trace_distinct_bytes=len(in_use),
                       trace_peak_bytes=trace_peak, **dev_bytes)
    print(json.dumps({"single_card_flags": summary}), flush=True)


def _same(name, got, want):
    """Require a card tensor equal to a CPU tensor, dtype included."""
    import torch

    _require(got.dtype == want.dtype and torch.equal(got.cpu(), want),
             f"{name}: card differs from CPU ({got.dtype}, {want.dtype})")


def check_gather_ops():
    """Phase 11a: the gather engine's ops on the card against the CPU,
    tolerance 0."""
    import numpy as np
    import torch

    from vvc_affine_tpu_torch import testing
    from vvc_affine_tpu_torch.ops import equations as eq
    from vvc_affine_tpu_torch.ops import gradient as gr
    from vvc_affine_tpu_torch.ops import interp as ip

    dev, cpu = torch.device("cuda:0"), torch.device("cpu")
    rng = np.random.default_rng(11)

    def both(*arrays):
        return [[torch.as_tensor(a, device=d) for a in arrays]
                for d in (dev, cpu)]

    # sub-blocks at and next to each frame edge, integer motion that keeps
    # the window inside or pulls it up to 24 samples past the edge, and
    # every one of the 16x16 phase pairs
    ref = testing.affine_gop(FW, FH, 1, seed=3)[1][0].astype(np.int32)
    edge_x = [0, 4, FW // 2, FW - 8, FW - 4]
    edge_y = [0, 4, FH // 2, FH - 8, FH - 4]
    shift = [-24, -3, 0, 3, 24]
    bx, by, mx, my = (a.reshape(-1, 1).astype(np.int32) for a in np.meshgrid(
        edge_x, edge_y, shift, shift, indexing="ij"))
    ph = np.arange(256, dtype=np.int32)
    mvx = mx * 16 + (ph % 16)[None, :]
    mvy = my * 16 + (ph // 16)[None, :]
    (g, c) = both(ref.ravel(), bx, by, mvx, mvy)
    _same("predict_subblocks", ip.predict_subblocks(g[0], FW, FH, *g[1:]),
          ip.predict_subblocks(c[0], FW, FH, *c[1:]))
    n_pred = mvx.size

    win = rng.integers(0, 1024, (256, 11, 11)).astype(np.int32)
    win[:2] = 1023
    win[2:4, ::2, ::2] = 0                       # checkerboards of extremes
    (g, c) = both(win, ph % 16, ph // 16)
    for last in (False, True):
        _same(f"filter_windows(last={last})", ip.filter_windows(*g, last),
              ip.filter_windows(*c, last))

    for h, w in ((16, 16), (32, 64), (128, 128)):
        pl = rng.integers(0, 1024, (64, h, w)).astype(np.int32)
        (g, c) = both(pl)
        got, want = gr.sobel_cu(*g), gr.sobel_cu(*c)
        for k in range(2):
            _same(f"sobel_cu {h}x{w}", got[k], want[k])

    lim = 1 << 27                                # |moment| < 2^60: no wrap
    grads = rng.integers(-lim, lim, (3, 16, 32, 64)).astype(np.int32)
    grads[:, 0] = lim - 1
    grads[1, 1] = -lim
    (g, c) = both(*grads)
    mg, mc = eq.gradient_moments(*g), eq.gradient_moments(*c)
    for k in range(5):
        _same(f"gradient_moments[{k}]", mg[k], mc[k])
    for n_cp in (2, 3):
        fac = eq.subblock_factors(8, 16, n_cp)
        got = eq.assemble_system(*mg, eq.factors_to(fac, dev))
        want = eq.assemble_system(*mc, eq.factors_to(fac, cpu))
        _same(f"assemble_system M {n_cp}CP", got[0], want[0])
        _same(f"assemble_system rhs {n_cp}CP", got[1], want[1])
    print(f"[gather] ops card == CPU: predict_subblocks on {n_pred} "
          f"sub-blocks at and past every frame edge (all 256 phases), "
          f"filter_windows (last=False/True), sobel_cu, gradient_moments, "
          f"assemble_system (2CP/3CP)", flush=True)


def check_gather_pair():
    """Phase 11b: one 2CP->3CP chain per mode at 416x240, called twice on
    the card (default device): the first call captures each stage's CUDA
    graph, the second replays on another input set (``affine_gop`` seeds 5
    and 6).  Each is bit-identical to the gather chain on the CPU (eager)
    and to the plane pair on the card on the same set; the card's gather
    chain launches no kernel."""
    import torch

    from vvc_affine_tpu_torch import kernels, testing
    from vvc_affine_tpu_torch.models import affine_me as me
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.runtime import graphs

    sets = [testing.affine_gop(SMALL_W, SMALL_H, 1, seed=k) for k in (5, 6)]
    for mode in ("full", "half"):
        z = ap.zero_cpmvs(ap.PlaneSpec(mode, 2, SMALL_W, SMALL_H), "cpu")
        gather = {d: [me.build_stage(me.StageSpec(mode, n, SMALL_W,
                                                  SMALL_H), d)
                      for n in (2, 3)]
                  for d in (None, torch.device("cpu"))}
        card_stages = gather[None]
        _require(all(isinstance(g, graphs.Graphed) and g.graph is None
                     for g in card_stages),
                 f"{mode}: the card's gather stages are not new graphs")
        for k, (o_np, r_np) in enumerate(sets):
            outs = {}
            for name, d in (("gather card", None),
                            ("gather CPU", torch.device("cpu")),
                            ("plane card", None)):
                args = ap.stage_inputs_from_numpy(r_np[0], o_np[0], 57.54, z,
                                                  d)
                kernels.reset_launches()
                if name.startswith("gather"):
                    s2, s3 = gather[d]
                    c2, p2 = s2(*args)
                    out = (c2, p2, *s3(*args[:3], p2))
                    _require(not any(kernels.launches.values()),
                             f"{name}: kernel launches {kernels.launches}")
                else:
                    out = ap.build_pair_stage(
                        ap.PlaneSpec(mode, 2, SMALL_W, SMALL_H),
                        ap.PlaneSpec(mode, 3, SMALL_W, SMALL_H),
                        device=d)(*args)
                _require(out[0].device.type == ("cpu" if d else "cuda"),
                         f"{name}: outputs on {out[0].device}")
                _require([o.dtype for o in out]
                         == [torch.int64, torch.int32] * 2,
                         f"{name}: dtypes {[o.dtype for o in out]}")
                outs[name] = [o.cpu() for o in out]
            _require([g.replays for g in card_stages] == [k, k],
                     f"{mode} set {k}: gather graph replays "
                     f"{[g.replays for g in card_stages]}, want {k}")
            for name in ("gather CPU", "plane card"):
                _require(all(torch.equal(a, b) for a, b in
                             zip(outs["gather card"], outs[name])),
                         f"{mode} chain, set {k}: gather card differs from "
                         f"{name}")
        print(f"[gather] {mode} chain at {SMALL_W}x{SMALL_H}: gather card "
              f"(captured, then replayed on another set) == gather CPU == "
              f"plane card on both sets (costs int64, CPMVs int32)",
              flush=True)


def run_gather_path(csvs, plane_logs, profile):
    """Phase 11c: ``cli.main --Engine gather`` at 1080p -f 2 on phase 6's
    CSVs: no kernel launch, phase 6's decision logs byte for byte, the
    CUDA-event seconds of each stage (the CLI's timing report) and per
    frame-ref, the first (which warms up and captures the four stage
    graphs) apart from the replayed ones, and the run's peak device
    memory."""
    import torch

    from vvc_affine_tpu_torch import cli, kernels
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    opath, rpath = csvs
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gather")
        torch.cuda.synchronize()
        memory = {"start_bytes": torch.cuda.memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-f", "2", "-s", f"{FW}x{FH}", "-q", "32",
                           "-o", opath, "-r", rpath, "-l", prefix,
                           "--Engine", "gather"])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        memory["peak_bytes"] = torch.cuda.max_memory_allocated()
        launches = dict(kernels.launches)
        _require(rc == 0, f"cli.main --Engine gather returned {rc}")
        _require(not any(launches.values()),
                 f"gather path launched kernels: {launches}")
        logs = _log_bytes(prefix)
    _require(sorted(logs) == sorted(plane_logs), "gather path: log names "
             "differ from the plane path's")
    differ = [k for k in logs if logs[k] != plane_logs[k]]
    _require(not differ, f"gather path: logs differ from the plane path's: "
                         f"{differ}")
    # the timing report's per-dispatch lines: "EXEC <pred> POC p ref r,<ns>"
    lines = buf.getvalue().splitlines()
    stage_s = {ln.rsplit(",", 1)[0]: float(ln.rsplit(",", 1)[1]) / 1e9
               for ln in lines if ln.startswith("EXEC ")}
    _require(len(stage_s) == 12, f"{len(stage_s)} timed stages, want 12")
    first, *later = frame_ref_s(lines).values()
    print(json.dumps({"gather_path": {
        "cli_s": cli_s, "launches": launches, "logs_identical": len(logs),
        "frame_ref_s": {"first_capturing": first, "replayed": later},
        "memory": memory, "stage_s": stage_s}}), flush=True)
    if profile:
        profile_gather_stages()


def profile_gather_stages():
    """Phase 11c with ``--profile``: the device launches and device-busy
    time of one FULL and one HALF 2CP gather stage on the main path's
    first inputs, run eagerly (``affine_me.eager_stage_fn``, first) and as
    the main path's replayed graph (``affine_me.build_stage``)."""
    import torch

    from vvc_affine_tpu_torch.models import affine_me as me

    dev = torch.device("cuda:0")
    for run in ("eager", "replayed"):
        for mode in ("full", "half"):
            spec = me.StageSpec(mode, 2, FW, FH)
            fn = (me.eager_stage_fn(spec, dev) if run == "eager"
                  else me.build_stage(spec))
            args = _path_inputs(mode)
            fn(*args)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def stage():
                start.record()
                fn(*args)
                end.record()

            events = _device_events(stage)
            stage_ms = start.elapsed_time(end)
            busy_ms = sum(ev.device_time_total for ev in events) / 1e3
            print("[profile] " + json.dumps({
                "gather_stage": f"{mode} 2CP", "run": run,
                "frame": f"{FW}x{FH}", "stage_ms": stage_ms,
                "device_busy_ms": busy_ms,
                "idle_share": 1 - busy_ms / stage_ms,
                "device_launches": len(events)}), flush=True)


def check_gather_graphs():
    """Phase 11e: per (mode, n_cp) the main path's captured 1080p gather
    stage (``affine_me.build_stage``, captured by phase 11c's first
    frame-ref) fed the four input sets of ``_graph_inputs`` in turn, the
    3CP stage on its 2CP output, each output bit-identical to the eager
    loop's (``affine_me.eager_stage_fn``) on the same set, also after the
    later replays; no kernel launched.  A ``gather_graph`` JSON line:
    capture seconds per stage, the replayed and the eager stage's seconds
    per set (CUDA events) and the kernel launches per replay."""
    import torch

    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models import affine_me as me
    from vvc_affine_tpu_torch.runtime import graphs

    dev = torch.device("cuda:0")
    sets = _graph_inputs()

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    rows = {}
    for mode in ("full", "half"):
        stages = {}
        for n in (2, 3):
            spec = me.StageSpec(mode, n, FW, FH)
            g = me.build_stage(spec)
            _require(isinstance(g, graphs.Graphed) and g.graph is not None,
                     f"{mode} {n}CP: build_stage is not a captured graph")
            stages[n] = (g, me.eager_stage_fn(spec, dev), g.replays)
        kept = []
        secs = {n: {"replayed": [], "eager": []} for n in (2, 3)}
        kernels.reset_launches()
        for i, inputs in enumerate(sets):
            args = inputs[mode]
            prev = args[3]
            for n in (2, 3):
                g, eager, _ = stages[n]
                got, g_s = timed(g, *args[:3], prev)
                want, e_s = timed(eager, *args[:3], prev)
                _same_outputs(f"gather {mode} {n}CP, set {i}", got, want)
                kept.append((got, want))
                secs[n]["replayed"].append(g_s)
                secs[n]["eager"].append(e_s)
                prev = want[1]
        for i, (got, want) in enumerate(kept):
            _same_outputs(f"gather {mode} stage {i}, kept", got, want)
        _require(not any(kernels.launches.values()),
                 f"gather {mode}: kernel launches {kernels.launches}")
        for n, (g, _, before) in stages.items():
            _require(g.replays == before + len(sets),
                     f"gather {mode} {n}CP: {g.replays - before} replays, "
                     f"want {len(sets)}")
            rows[f"{mode} {n}CP"] = {"capture_s": g.capture_s,
                                     "launches_per_replay": g.launches,
                                     "stage_s": secs[n]}
        print(f"[gather] {mode} 1920x1080: 4 input sets, 2CP and 3CP "
              f"replays bit-identical to the eager loop, no kernel launch",
              flush=True)
    print(json.dumps({"gather_graph": rows}), flush=True)


def check_native_ingest(csvs):
    """Phase 11d: phase 6's CSVs through the native parser and the plain
    Python parser: equal arrays; both times."""
    import numpy as np

    from vvc_affine_tpu_torch.runtime import frames as frames_io

    for path in csvs:
        t0 = time.perf_counter()
        fast = frames_io.read_frames_csv(path, FW, FH, 2)
        t1 = time.perf_counter()
        plain = frames_io.read_frames_csv_plain(path, FW, FH, 2)
        t2 = time.perf_counter()
        _require(fast.dtype == plain.dtype and np.array_equal(fast, plain),
                 f"{path}: native parse differs from the plain parser")
        print("[native] " + json.dumps({
            "csv": os.path.basename(path), "bytes": os.path.getsize(path),
            "samples": int(fast.size), "native_s": t1 - t0,
            "plain_s": t2 - t1}), flush=True)


def _pipeline_run(csvs, devices=None, eager=False, engine="plane",
                  check=None):
    """The 1080p -f 2 pipeline of ``engine`` on phase 6's CSVs, logs
    through ``reporting``: on card 0, or split over ``devices`` (phase
    12a); with ``eager``, each pair run by its eager loop
    (``eager_pair_fn``) in place of its graph (phase 6b).  ``check(pipe)``,
    when given, runs on the pipeline after the run.  Returns the logs, the
    launch counts, the seconds per frame-ref and the device memory of the
    run (bytes at its start, its peak)."""
    import torch

    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models import affine_plane as ap
    from vvc_affine_tpu_torch.models.pipeline import (AffineMEPipeline,
                                                      PipelineConfig)
    from vvc_affine_tpu_torch.parallel import mesh as pmesh
    from vvc_affine_tpu_torch.runtime import frames as frames_io
    from vvc_affine_tpu_torch.runtime import reporting
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    orig, ref = (frames_io.read_frames_csv(p, FW, FH, 2) for p in csvs)
    dev = torch.device("cuda:0")
    pipe = AffineMEPipeline(PipelineConfig(
        FW, FH, 32, device=dev, engine=engine,
        mesh=pmesh.make_mesh(devices) if devices else None))
    if eager:
        pipe.pairs = {m: ap.eager_pair_fn(ap.PlaneSpec(m, 2, FW, FH),
                                          ap.PlaneSpec(m, 3, FW, FH), dev)
                      for m in pipe.pairs}
    cards = set(devices or [dev])
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "run")

        def on_result(r):
            reporting.report_results(prefix, r.pred, FW, r.costs.cpu().numpy(),
                                     r.cpmvs.cpu().numpy(), r.poc, r.ref_idx)

        timing = reporting.Timing()
        for d in cards:
            torch.cuda.synchronize(d)
        memory = {"start_bytes": torch.cuda.memory_allocated(dev)}
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            pipe.encode(orig, ref, on_result=on_result, timing=timing)
        for d in cards:
            torch.cuda.synchronize(d)
        launches = dict(kernels.launches)
        memory["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        logs = _log_bytes(prefix)
    if check is not None:
        check(pipe)
    return logs, launches, frame_ref_s(
        f"{label},{sec * 1e9}" for label, sec in timing.events), memory


def run_eager_path(csvs, plane_logs):
    """Phase 6b(b): the 1080p -f 2 pipeline with every pair run eagerly, in
    this process after phase 6: its 40 logs byte-identical to phase 6's
    (produced by the graphs), 60 K1, 66 K2, 60 motion-plane and 66 CU fold
    launches.
    Returns its seconds per frame-ref and memory."""
    logs, launches, frame_s, memory = _pipeline_run(csvs, eager=True)
    want = _path_launches({k: 3 * v for k, v in PAIR_LAUNCHES.items()})
    _require(launches == want, f"eager pipeline: launches {launches}, "
                               f"want {want}")
    differ = [k for k in plane_logs if logs.get(k) != plane_logs[k]]
    _require(logs == plane_logs, f"eager pipeline: logs differ from the "
                                 f"graphs' (phase 6): {differ}")
    print(f"[graph] the eager 1080p pipeline's 40 logs == phase 6's (graph "
          f"replays), K1 {launches['warp']} and K2 "
          f"{launches['blockreduce']} launches", flush=True)
    return frame_s, memory


def graph_summary(card, main_s, main_memory, eager_s, eager_memory,
                  capture_s, launches, busy_share):
    """Phase 6b(c): the ``graph`` JSON line."""
    import torch

    from vvc_affine_tpu_torch.models import affine_plane as ap

    dev = torch.device("cuda:0")
    pair_capture_s = {m: ap.build_pair_stage(
        ap.PlaneSpec(m, 2, FW, FH), ap.PlaneSpec(m, 3, FW, FH),
        dev).capture_s for m in ("full", "half")}
    first, *later = main_s.values()
    row = {"card": card, "frame": f"{FW}x{FH}",
           "frame_ref_s": {"graphs_first_capturing": first,
                           "graphs_replayed": later,
                           "eager": list(eager_s.values())},
           "main_path_capture_s": pair_capture_s,
           "phase_6b_capture_s": capture_s,
           "launches": launches,
           "memory_graphs": main_memory, "memory_eager": eager_memory,
           "busy_share_replayed_frame_ref": busy_share.get("replayed"),
           "busy_share_eager_frame_ref": busy_share.get("eager")}
    print(json.dumps({"graph": row}), flush=True)


def _split_cli(n, csvs):
    """Phase 12a on N distinct cards: ``cli.main --NumChips N`` at 1080p
    -f 2.  Returns the logs, the launch counts and the seconds per
    frame-ref."""
    import torch

    from vvc_affine_tpu_torch import cli, kernels
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "split")
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-f", "2", "-s", f"{FW}x{FH}", "-q", "32",
                           "-o", csvs[0], "-r", csvs[1], "-l", prefix,
                           "--NumChips", str(n)])
        for i in range(n):
            torch.cuda.synchronize(i)
        launches = dict(kernels.launches)
        _require(rc == 0, f"cli.main --NumChips {n} returned {rc}")
        logs = _log_bytes(prefix)
    return logs, launches, frame_ref_s(buf.getvalue().splitlines())


def _two_processes(argv, tmp, stem, distinct=False, timeout=300):
    """Phase 12b/c: ``python -m vvc_affine_tpu_torch.cli`` as processes 0
    and 1 of a gloo group on a free local port, process k with ``-l
    <tmp>/<stem><k>``, both on card 0 or (``distinct``) process k on card
    k.  Both must exit 0 within ``timeout`` seconds; otherwise both are
    killed and the phase fails.  Returns their outputs and the wall
    seconds."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # both processes on this host: gloo on the loopback interface
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vvc_affine_tpu_torch.cli", *argv,
         "-l", os.path.join(tmp, f"{stem}{k}"),
         "--Coordinator", f"127.0.0.1:{port}", "--NumProcesses", "2",
         "--ProcessId", str(k), "--DeviceIndex", str(k if distinct else 0)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, timeout - (time.time() - t0)))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{stem}: the two CLI processes did not end "
                           f"within {timeout} s; both killed")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall_s = time.time() - t0
    for k, (p, out) in enumerate(zip(procs, outs)):
        _require(p.returncode == 0, f"{stem}: process {k} exited "
                                    f"{p.returncode}:\n{out[-3000:]}")
    return outs, wall_s


def check_split(csvs, plane_logs, main_s):
    """Phase 12: the CTU-axis split held on the card, in one process
    (N = 2, 4 shards on one card; with ``--NumChips N`` on distinct cards
    where there are N) and in two processes (1080p on one card, and on two
    cards where there are two; a 416x240 run resumed across them)."""
    import torch

    from vvc_affine_tpu_torch import cli, testing
    from vvc_affine_tpu_torch.runtime import frames as frames_io
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    summary = {"phase6_frame_ref_s": main_s}
    cards = torch.cuda.device_count()
    for n in (2, 4):
        layouts = {"one card": [torch.device("cuda:0")] * n}
        if cards >= n:
            layouts["distinct cards"] = [torch.device("cuda", i)
                                         for i in range(n)]
        for name, devices in layouts.items():
            logs, launches, frame_s = (
                _pipeline_run(csvs, devices)[:3] if name == "one card"
                else _split_cli(n, csvs))
            want = _path_launches({k: n * 3 * v
                                   for k, v in PAIR_LAUNCHES.items()})
            _require(launches == want, f"split {n} on {name}: launches "
                                       f"{launches}, want {want}")
            differ = [k for k in plane_logs if logs.get(k) != plane_logs[k]]
            _require(logs == plane_logs, f"split {n} on {name}: logs differ "
                                         f"from phase 6's: {differ}")
            summary[f"{n} shards, {name}"] = {
                "frame_ref_s": frame_s, "launches": launches,
                "logs_identical": len(logs)}
            print(f"[split] {n} shards on {name}: 40 logs == phase 6's, K1 "
                  f"{launches['warp']} and K2 {launches['blockreduce']} "
                  f"launches", flush=True)

    from vvc_affine_tpu_torch.runtime import graphs

    def one_graph_per_card(pipe):
        for key, fn in pipe.stages.items():
            _require(list(fn.per_device) == [torch.device("cuda:0")]
                     and all(isinstance(g, graphs.Graphed) and g.replays == 2
                             for g in fn.per_device.values()),
                     f"gather split {key}: not one graph on card 0, "
                     f"captured and replayed twice")

    logs, launches, frame_s, _ = _pipeline_run(
        csvs, [torch.device("cuda:0")] * 2, engine="gather",
        check=one_graph_per_card)
    _require(launches == _path_launches({}),
             f"gather split 2 on one card: launches {launches}")
    differ = [k for k in plane_logs if logs.get(k) != plane_logs[k]]
    _require(logs == plane_logs, f"gather split 2 on one card: logs differ "
                                 f"from phase 6's: {differ}")
    summary["gather, 2 shards, one card"] = {
        "frame_ref_s": frame_s, "launches": launches,
        "logs_identical": len(logs)}
    print("[split] gather engine, 2 shards on one card (one graph per "
          "stage): 40 logs == phase 6's, no kernel launch", flush=True)

    opath, rpath = csvs
    with tempfile.TemporaryDirectory() as tmp:
        for name, stem, distinct in (("one card", "a", False),
                                     ("two cards", "b", True))[:cards]:
            outs, wall_s = _two_processes(
                ["-f", "2", "-s", f"{FW}x{FH}", "-q", "32", "-o", opath,
                 "-r", rpath], tmp, stem, distinct)
            logs = _log_bytes(os.path.join(tmp, f"{stem}0"))
            _require(logs == plane_logs, f"two processes on {name}: "
                     "process 0's logs differ from phase 6's")
            _require(not [f for f in os.listdir(tmp)
                          if f.startswith(f"{stem}1")],
                     f"two processes on {name}: process 1 wrote logs")
            summary[f"two processes, {name}"] = {
                "frame_ref_s": [frame_ref_s(o.splitlines()) for o in outs],
                "wall_s": wall_s, "logs_identical": len(logs)}
            print(f"[split] two processes on {name}: process 0's 40 logs "
                  f"== phase 6's, process 1 wrote none", flush=True)

        orig_g, recon_g = testing.affine_gop(SMALL_W, SMALL_H, 2, seed=1)
        small = [os.path.join(tmp, f) for f in ("so.csv", "sr.csv")]
        frames_io.write_frames_csv(small[0], orig_g)
        frames_io.write_frames_csv(small[1], recon_g)
        base = ["-s", f"{SMALL_W}x{SMALL_H}", "-q", "32", "-o", small[0],
                "-r", small[1]]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-f", "2"] + base
                          + ["-l", os.path.join(tmp, "whole")])
        _require(rc == 0, f"uninterrupted 416x240 run returned {rc}")
        ckpt = ["--CheckpointDir", os.path.join(tmp, "ckpt")]
        _two_processes(["-f", "1"] + base + ckpt, tmp, "r")
        _two_processes(["-f", "2"] + base + ckpt, tmp, "r")
        want = _log_bytes(os.path.join(tmp, "whole"))
        got = _log_bytes(os.path.join(tmp, "r0"))
        _require(len(want) == len(plane_logs) and got == want,
                 "resumed two-process run: logs differ from the "
                 "uninterrupted run's")
        _require(not [f for f in os.listdir(tmp) if f.startswith("r1")],
                 "resumed two-process run: process 1 wrote logs")
        summary["resumed two processes, 416x240"] = {
            "logs_identical": len(got)}
        print("[split] two processes at 416x240, -f 1 then -f 2 resumed: "
              "logs == the uninterrupted run's", flush=True)
        outs, wall_s = _two_processes(["-f", "2", "--Engine", "gather"]
                                      + base, tmp, "g")
        got = _log_bytes(os.path.join(tmp, "g0"))
        _require(got == want, "two gather processes at 416x240: process "
                              "0's logs differ from the one-process run's")
        _require(not [f for f in os.listdir(tmp) if f.startswith("g1")],
                 "two gather processes: process 1 wrote logs")
        summary["two gather processes, 416x240"] = {
            "frame_ref_s": [frame_ref_s(o.splitlines()) for o in outs],
            "wall_s": wall_s, "logs_identical": len(got)}
        print("[split] two gather processes at 416x240: process 0's logs "
              "== the one-process run's, process 1 wrote none", flush=True)
    print(json.dumps({"split": summary}), flush=True)


def _tool(name, *args, timeout):
    """Phase 13: ``python -m vvc_affine_tpu_torch.tools.<name> args`` in a
    child process of its own session.  Fails unless it exits 0 within
    ``timeout`` seconds; every process of its session is killed when it
    ends.  Returns its output (stdout and stderr) and wall seconds."""
    import signal

    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, "-m", f"vvc_affine_tpu_torch.tools.{name}", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    out = None
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    _require(out is not None, f"tool {name}: no end within {timeout} s; "
                              f"killed")
    _require(p.returncode == 0,
             f"tool {name} exited {p.returncode}:\n{out[-3000:]}")
    return out, time.time() - t0


def _json_line(out, key):
    """The tool's last ``{"<key>": ...}`` line, its value."""
    for ln in reversed(out.splitlines()):
        if ln.startswith('{"' + key + '"'):
            return json.loads(ln)[key]
    raise RuntimeError(f"no {key} line in:\n{out[-2000:]}")


def run_power_tools(csvs, plane_logs, card, tmp):
    """Phase 13a: ``tools.power_trace`` around the 1080p -f 2 CLI on phase
    6's CSVs, then ``tools.energy_report`` on its trace and log.  Every
    power sample a number above 0 W, every phase's mean at most the card's
    power limit, every EXEC window sampled, the logs phase 6's."""
    from vvc_affine_tpu_torch.tools import energy_report as er
    from vvc_affine_tpu_torch.tools.gop_golden import frame_ref_s

    trace = os.path.join(tmp, "power.csv")
    prefix = os.path.join(tmp, "power_")
    out, wall_s = _tool(
        "power_trace", "--out", trace, "--", sys.executable, "-m",
        "vvc_affine_tpu_torch.cli", "-f", "2", "-s", f"{FW}x{FH}", "-q",
        "32", "-o", csvs[0], "-r", csvs[1], "-l", prefix, timeout=300)
    log = os.path.join(tmp, "power_run.log")
    with open(log, "w") as f:
        f.write(out)
    _require(_log_bytes(prefix) == plane_logs,
             "the CLI under power_trace: logs differ from phase 6's")
    rows, field = er.parse_trace(trace)
    power = [r[3] for r in rows]
    _require(rows and all(w is not None and w > 0 for w in power),
             f"power samples not all above 0 W: {sorted(set(power))[:5]}")
    limit = float(card.split(",")[1].split()[0])
    phases = er.parse_stamps(log)
    execs = [p for p in phases if p[0].startswith("EXEC")]
    _require(len(execs) == 6, f"{len(execs)} EXEC windows, want 6")
    per_phase = {}
    for label, a, b in phases:
        pp = er.phase_power(rows, a, b)
        _require(pp is not None or not label.startswith("EXEC"),
                 f"no power sample inside {label}")
        if pp is None:
            continue
        _require(pp[0] <= limit, f"{label}: mean {pp[0]} W above the "
                                 f"{limit} W limit")
        per_phase[label] = {"seconds": b - a, "mean_w": pp[0],
                            "energy_j": pp[1], "distinct_readings": pp[2]}
    report, _ = _tool("energy_report", "--trace", trace, "--log", log,
                      timeout=120)
    for ln in report.splitlines():
        print(f"[energy] {ln}", flush=True)
    total = [ln for ln in report.splitlines() if ln.startswith("TOTAL_EXEC,")]
    _require(len(total) == 1, "energy_report printed no TOTAL_EXEC line")
    _, mean_w, energy_j, distinct, refs, per_ref = total[0].split(",")
    _require(int(refs) == 3, f"{refs} frame-refs in the report, want 3")
    print(f"[tools] power_trace: {len(rows)} samples of {field}, max "
          f"{max(power)} W beside the {limit} W limit", flush=True)
    return {"field": field, "samples": len(rows),
            "distinct_readings": len(set(power)), "max_w": max(power),
            "limit_w": limit, "exec_mean_w": float(mean_w),
            "exec_energy_j": float(energy_j),
            "joules_per_frame_ref": float(per_ref),
            "frame_ref_s": frame_ref_s(out.splitlines()),
            "phases": per_phase, "wall_s": wall_s}


def run_tools(csvs, plane_logs, card):
    """Phase 13: every measurement tool of ``vvc_affine_tpu_torch/tools``
    in a child, as a user runs it (``python -m``), each result checked:
    (a) power_trace + energy_report; (b) profile_stage at 1080p, FULL and
    --half; (c) xprof_trace at 1080p, which must find K1 and K2 among the
    device ops of one frame-ref (at most the 20 and 22 launched); (d)
    tpu_parity at 832x480, every stage bit-identical; (e) gop_golden at
    3840x2160 -f 2, byte-identical logs, K1/K2 60/66 launches in the plane
    child and none in the gather child;
    (f) scaling_bench at 1080p over 1, 2 and 4 shards, equal results;
    (g) one pair per mode at 4K in this process under the profiler."""
    import shutil

    import torch

    torch.cuda.empty_cache()
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        summary["power"] = run_power_tools(csvs, plane_logs, card, tmp)

        for flags in ([], ["--half"]):
            out, wall_s = _tool("profile_stage", f"{FW}x{FH}", *flags,
                                timeout=300)
            res = _json_line(out, "profile_stage")
            rows = {r["piece"]: r for r in res["pieces"]}
            _require(len(rows) == 11 and all(
                r["event_ms"] > 0 and r["host_ms"] > 0 for r in rows.values()),
                f"profile_stage {flags}: pieces {sorted(rows)}")
            for piece in ("K1 warp", "K2 refine", "K2 satd only", "fold_cu"):
                _require(rows[piece]["device_launches"] >= 1,
                         f"profile_stage: {piece} launched nothing")
            for r in res["pieces"]:
                print(f"[profile_stage] {res['mode']} {json.dumps(r)}",
                      flush=True)
            summary[f"profile_stage {res['mode']}"] = {"wall_s": wall_s}

        xdir = os.path.join(tmp, "xprof")
        out, wall_s = _tool("xprof_trace", f"{FW}x{FH}", "--out", xdir,
                            timeout=300)
        res = _json_line(out, "xprof_trace")
        shutil.rmtree(xdir)
        # the profiler may miss a few of a frame-ref's ~68k device
        # events, so: found, and never more than the 20 / 22 launched
        found = res["hand_written_launches"]
        _require(1 <= found["K1"] <= 20 and 1 <= found["K2"] <= 22,
                 f"xprof_trace found {found}, want 20 K1 and 22 K2")
        for name, ms, n in res["top_ops"][:12]:
            print(f"[xprof] {ms:.3f} ms {n} launches {name[:100]}",
                  flush=True)
        summary["xprof_trace"] = {"wall_s": wall_s, **{k: res[k] for k in (
            "window_ms", "device_busy_ms", "busy_share", "device_launches",
            "hand_written_launches", "hand_written_ms")}}

        path = os.path.join(tmp, "parity.json")
        out, wall_s = _tool("tpu_parity", "832x480", "--out", path,
                            timeout=300)
        res = _json_line(out, "tpu_parity")
        _require(res["ok"] and len(res["stages"]) == 8 and set(
            res["stages"].values()) == {"bit-identical"},
            f"tpu_parity: {res['stages']}")
        print(f"[tools] tpu_parity 832x480: 8 stage outputs on the card == "
              f"the CPU golden ({wall_s:.1f} s)", flush=True)
        summary["tpu_parity"] = {"stages": 8, "wall_s": wall_s}

        path = os.path.join(tmp, "gop.json")
        out, wall_s = _tool("gop_golden", "3840x2160", "--frames", "2",
                            "--out", path, timeout=600)
        res = _json_line(out, "gop_golden")
        _require(res["verdict"] == "byte-identical"
                 and res["n_log_files"] == 40,
                 f"gop_golden 4K: {res['verdict']}, {res['n_log_files']} "
                 f"logs")
        want = {"plane": _path_launches({k: 3 * v for k, v in
                                         PAIR_LAUNCHES.items()}),
                "gather": _path_launches({})}
        _require(res["launches"] == want,
                 f"gop_golden 4K launches {res['launches']}, want {want}")
        print(f"[tools] gop_golden 3840x2160 -f 2: 40 logs byte-identical, "
              f"K1/K2 60/66 (plane) and 0/0 (gather) ({wall_s:.1f} s)",
              flush=True)
        for e in ("plane", "gather"):
            print(f"[tools] gop_golden {e}: first (capturing) frame-ref "
                  f"{res['first_frame_ref_s'][e]} s, replayed "
                  f"{res['later_frame_ref_s'][e]} s, peak "
                  f"{res['max_memory_allocated'][e]} B", flush=True)
        summary["gop_golden"] = {k: res[k] for k in (
            "wall_s", "frame_ref_s", "first_frame_ref_s",
            "later_frame_ref_s", "max_memory_allocated")}

        out, wall_s = _tool("scaling_bench", f"{FW}x{FH}", "--chips",
                            "1,2,4", timeout=300)
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"chips"')]
        _require([ln["chips"] for ln in lines] == [1, 2, 4],
                 f"scaling_bench lines {lines}")
        _require(len({ln["results_sha256"] for ln in lines}) == 1,
                 "scaling_bench: the shards' results differ from one "
                 "shard's")
        for ln in lines:
            print(f"[scaling] {json.dumps(ln)}", flush=True)
        summary["scaling_bench"] = {"wall_s": wall_s}
    summary["pairs_4k"] = profile_pairs_4k()
    print(json.dumps({"tools": summary}), flush=True)


def _ancestor(sp, name):
    while sp is not None and sp.name != name:
        sp = sp.parent
    return sp


def _key(d):
    return json.dumps(d, sort_keys=True)


def _traced_pipeline(frames, engine, devices):
    """Phase 14 for one configuration: returns its ``tracing`` line."""
    import torch

    from vvc_affine_tpu_torch.models import affine_me, affine_plane
    from vvc_affine_tpu_torch.models.pipeline import (AffineMEPipeline,
                                                      PipelineConfig)
    from vvc_affine_tpu_torch.parallel import mesh as pmesh
    from vvc_affine_tpu_torch.runtime import tracing

    orig, recon = frames
    label = f"{engine} on {[str(d) for d in devices]}"

    def make():
        # graphs captured anew, not those an earlier phase left cached
        for cached in (affine_plane._pair_fn, affine_plane._stage_fn,
                       affine_me._stage_fn):
            cached.cache_clear()
        return AffineMEPipeline(PipelineConfig(
            FW, FH, 32, device=devices[0], engine=engine,
            mesh=pmesh.make_mesh(devices) if len(devices) > 1 else None))

    def graphed(pipe):
        fns = list(pipe.pairs.values()) + list(pipe.stages.values())
        return [g for fn in fns
                for g in getattr(fn, "per_device", {None: fn}).values()]

    pipe = make()
    per_ref, drains = [], []
    with tracing.record() as rec:
        def on_result(r):
            r.costs.cpu(), r.cpmvs.cpu()
            if r.pred == 3:
                per_ref.append(list(rec.spans))
                drains.append((rec.drain(), rec.unresolved))
        pipe.encode(orig, recon, on_result)
    graphs_ = graphed(pipe)
    nodes = [dict(g.nodes) for g in graphs_]
    setup, _ = drains[0]
    # each graph's nodes are counted once, at its first traced replay
    first = drains[1][0]["counters"].get("graphs.nodes", [])
    own = [{"card": str(g.device), **n} for g, n in zip(graphs_, nodes)]
    _require("graphs.nodes" not in setup["counters"] and sorted(
        map(_key, first)) == sorted(map(_key, own)),
        f"tracing {label}: graphs.nodes {first} at the first replay "
        f"against the graphs' own {own}")
    _require(all("graphs.nodes" not in a["counters"] for a, _ in drains[2:]),
             f"tracing {label}: graphs.nodes counted twice")
    cap = setup["spans"]["graphs.capture"]
    _require(cap["count"] == len(graphs_) and abs(
        cap["host_s"] - sum(g.capture_s for g in graphs_)) < 1e-6,
        f"tracing {label}: graphs.capture {cap} against capture_s "
        f"{[g.capture_s for g in graphs_]}")
    per_frame_ref = sum(n["total"] for n in nodes)
    cards = sorted({str(g.device) for g in graphs_})
    for k, (agg, unresolved) in enumerate(drains[1:], 1):
        c = agg["counters"]
        _require(c["graphs.nodes_replayed"] == per_frame_ref
                 and c["graphs.replays"] == len(graphs_),
                 f"tracing {label}: frame-ref {k}: {c}, want "
                 f"{per_frame_ref} nodes in {len(graphs_)} replays")
        dev = agg["device"]
        _require(unresolved == 0 and sorted(dev) == cards and sum(
            d["replays"] for d in dev.values()) == len(graphs_),
            f"tracing {label}: frame-ref {k}: device {dev}, "
            f"{unresolved} unresolved")
    for spans in per_ref[1:]:
        for sp in spans:
            if sp.name.startswith("graphs."):
                d = _ancestor(sp, "pipeline.dispatch")
                _require(d is not None and "poc" in d.attrs,
                         f"tracing {label}: {sp} outside a dispatch")
                if len(devices) > 1:
                    issue = _ancestor(sp, "mesh.issue")
                    _require(issue is not None and issue.attrs["card"]
                             == sp.attrs["card"],
                             f"tracing {label}: {sp} outside its card's "
                             f"issue")
    # a second capture of the same configuration, with the recorder off,
    # counts the same nodes when a recorder replays it
    again = make()
    again.encode(orig[:1], recon[:1])
    _require(all(g.graph is not None and g.nodes is None
                 for g in graphed(again)) and not any(
        g is h for g in graphed(again) for h in graphs_),
        f"tracing {label}: the second pipeline did not capture anew")
    with tracing.record():
        again.encode(orig[:1], recon[:1])
    _require([dict(g.nodes) for g in graphed(again)] == nodes,
             f"tracing {label}: a second capture counts "
             f"{[g.nodes for g in graphed(again)]}, the first {nodes}")
    del again
    # with the recorder off a replay records no CUDA event
    recorded = []
    real = torch.cuda.Event.record
    torch.cuda.Event.record = lambda self, *a: (recorded.append(1),
                                                real(self, *a))[1]
    try:
        pipe.encode(orig[:1], recon[:1])
    finally:
        torch.cuda.Event.record = real
    for d in set(devices):
        torch.cuda.synchronize(d)
    _require(not recorded, f"tracing {label}: {len(recorded)} CUDA events "
                           f"recorded with the recorder off")
    replayed = [a for a, _ in drains[1:]]
    n = len(replayed)

    def mean_ms(name):
        return sum(a["spans"].get(name, {"host_s": 0.0})["host_s"]
                   for a in replayed) * 1e3 / n

    line = {
        "config": label, "graphs": len(graphs_), "nodes_per_graph": nodes,
        "nodes_per_frame_ref": per_frame_ref, "replayed_frame_refs": n,
        "device_ms_per_frame_ref": {
            c: sum(a["device"][c]["s"] for a in replayed) * 1e3 / n
            for c in cards},
        **{f"{name}_ms_per_frame_ref": mean_ms(name) for name in (
            "graphs.replay", "graphs.copy_in", "graphs.clone_out",
            "pipeline.dispatch", "pipeline.lambda", "pipeline.put",
            "pipeline.put.pin", "mesh.pin", "mesh.issue")},
        "capture_s": cap["host_s"],
        "bytes_staged": setup["counters"]["pipeline.bytes_staged"]}
    print(json.dumps({"tracing": line}), flush=True)
    return line


def check_tracing():
    """Phase 14: the recorder's spans, counters and replay events on the
    card (module docstring)."""
    import torch

    from vvc_affine_tpu_torch import testing

    frames = testing.affine_gop(FW, FH, 3, seed=14)
    card = torch.device("cuda:0")
    split = ([torch.device("cuda", i) for i in range(2)]
             if torch.cuda.device_count() >= 2 else [card, card])
    for engine, devices in (("plane", [card]), ("gather", [card]),
                            ("plane", split)):
        _traced_pipeline(frames, engine, devices)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 8: torch.profiler device times of "
                             "the kernels and of a 1080p pair per mode; and "
                             "in phase 11 of a 1080p gather stage per mode")
    parser.add_argument("--ab", metavar="DIR",
                        help="add phase 7b: time the warp.cu and "
                             "blockreduce.cu in DIR (another version of "
                             "csrc/, same C entry points) against this "
                             "tree's on the main path's launches, in turns")
    parser.add_argument("--ab-k2-masks", action="store_true",
                        help="the blockreduce.cu in DIR takes the int32 "
                             "per-sample border masks (the first K2 "
                             "design's interface, commit 1852060) "
                             "where this tree's takes per-block flags")
    parser.add_argument("--tracing-only", action="store_true",
                        help="run phases 1, 2 and 14 (the recorder) alone")
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
    if args.tracing_only:
        check_tracing()
        print(f"[total] {time.time() - t_start:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    rng = np.random.default_rng(2026)
    tables = {m: ap.build_tables(ap.PlaneSpec(m, 2, FW, FH), dev)
              for m in ("full", "half")}
    check_repl_tables(tables)
    orig_np, ref_np = (f[0].astype(np.int32).reshape(-1)
                       for f in testing.affine_gop(FW, FH, 1, seed=3))
    ref = torch.as_tensor(ref_np, device=dev)
    orig_pl, _ = ap.prep_inputs(ap.PlaneSpec("full", 2, FW, FH),
                                tables["full"],
                                torch.as_tensor(orig_np, device=dev), ref)
    warp_stats = check_warp(tables, ref, rng)
    br_stats = check_blockreduce(tables, orig_pl, rng)
    check_card_vs_cpu()
    mv_row = check_mvplanes()
    fold_row = check_cufold()
    with tempfile.TemporaryDirectory() as work:
        launches, csvs, plane_logs, main_s, main_memory = run_main_path(
            tables["full"].n_ctus, work)
        mv_row["launches"] = launches["mvplanes"]
        fold_row["launches"] = launches["cufold"]
        capture_s = check_graphs()
        eager_s, eager_memory = run_eager_path(csvs, plane_logs)
        path = capture_path_launches()
        rows, bound = time_kernels(tables, warp_stats, br_stats, launches,
                                   path)
        rows += [mv_row, fold_row]
        if args.ab:
            ab_compare(args.ab, path, tables, args.ab_k2_masks)
        del path
        busy_share = {}
        if args.profile:
            profile_kernels(bound)
            busy_share = profile_pairs()
        graph_summary(card, main_s, main_memory, eager_s, eager_memory,
                      capture_s, launches, busy_share)
        rows += check_probes()
        run_single_card_flags()

        check_gather_ops()
        check_gather_pair()
        run_gather_path(csvs, plane_logs, args.profile)
        check_native_ingest(csvs)
        check_gather_graphs()
        check_split(csvs, plane_logs, main_s)
        run_tools(csvs, plane_logs, card)
    check_tracing()

    print(f"[total] {time.time() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
