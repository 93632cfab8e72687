"""The benchmark of vvc_affine_tpu_torch: one cell, one run, one result line.

    python3 mebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m mebench.run ...``) from the root of a checkout that holds
``BENCHMARK.json``.  The cell names a configuration
(``mebench/configs/<name>.json``: frame size, QP, reference list, engine,
cards) and a traffic mix (``mebench/mixes/<name>.json``); per-layer
metrics are read by ``mebench/metrics/<name>.py``.  All are found by the
names in ``BENCHMARK.json``, so a new cell, mix or metric is new files and
entries only.

What a run does:

1. makes the mix's stream on the card from ``--seed`` and copies it to
   host arrays, as an encoder holds its frames;
2. builds ``AffineMEPipeline`` for the configuration and hands it the
   stream through ``encode``, a closed loop with one client: each
   frame-ref (one frame against one reference, FULL and HALF 2CP->3CP) is
   done when its four decisions are on the host, copied there by the
   result callback.  The first frame-ref, which captures the CUDA graphs,
   ends set-up; the window runs from its end for ``--seconds`` and closes
   at the first frame-ref done after that.  When the stream runs out the
   encoder starts it again, as the next sequence;
3. with ``--trace 0`` reports the end-to-end metrics: frame-refs per
   second, the 90th percentile of frame-ref latency (from the completion
   of the one before), card joules per frame-ref (``nvidia-smi``) and
   set-up seconds; with ``--trace 1`` reports the per-layer metrics: it
   records the port's spans and counters (``runtime.tracing``) from
   before the pipeline is built, and drains them at every frame-ref's
   completion; it passes the port's ``Timing`` to ``encode`` in the first
   20% of the window, then starts the next sequence without it
   (``Timing`` synchronises the card after every dispatch), and from 30%
   of the window on profiles a few whole frame-refs, after four that meet
   CUPTI's first-use costs (the profiler's first start initialises CUPTI,
   which slows every launch from then on, so the frame-refs from the
   profile on are read by no wall-clock reader).  Its set-up ends one
   frame-ref later, at the first that captures nothing: that one's first
   replay of each graph counts the graph's nodes;
4. once the window has closed and the program's state is freed, holds the
   decisions of frame-refs drawn from the seed against the plain reference
   (``mebench/reference.py``): every cost and CPMV must be equal.

It exits with 2 and prints no result when the cell's cards are not there,
and with 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.time()      # set-up is timed from here, before any import

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vvc_affine_tpu")
# the ranges an idle gap is charged to (traced run): the benchmark's own
# around its calls into the port, and the port's spans
RANGES = ("encode", "readback", "callback",
          "pipeline.put", "pipeline.lambda", "pipeline.dispatch",
          "graphs.copy_in", "graphs.replay", "graphs.clone_out",
          "mesh.inputs", "mesh.issue", "mesh.join")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build into ``vvc_affine_tpu_torch/_build``)."""
    base = os.path.join(ROOT, ".mebench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class _WindowClosed(Exception):
    """Raised by the result callback to end the stream."""


class _Untimed(Exception):
    """Raised by the result callback to start the next sequence without
    ``Timing`` (traced run)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(bench, workload, config, mix) of the cell ``name``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(cells)})")
    wl = cells[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[wl["config"]]
    cfg = load_json(os.path.join(root, cfg_file))
    mix = load_json(os.path.join(HERE, "mixes", wl["traffic"] + ".json"))
    return bench, wl, cfg, mix


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metric entries this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def metric_reader(name: str):
    """``read(records)`` of ``mebench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mebench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_sample(window, seed: int, mix: dict):
    """The frame-refs to check, drawn from the seed among those done in
    the window: ``early`` with fewer than four references, ``steady``
    with four."""
    rng = random.Random(seed)
    early = [k for k in window if k[1] < 4]
    steady = [k for k in window if k[1] >= 4]
    return (rng.sample(early, min(mix["check"]["early"], len(early)))
            + rng.sample(steady, min(mix["check"]["steady"], len(steady))))


def differing(got, want) -> int:
    """CU decisions (cost or any CPMV) that differ between two results."""
    (c, p), (rc, rp) = got, want
    return int(((c != rc.cpu()) | (p != rp.cpu()).flatten(-2).any(-1)).sum())


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, config=None, mix=None, hook=None):
    """One run of ``cell``; returns the result object.

    ``device`` (default: the cell's cards, ``cuda:0``...) and ``config`` /
    ``mix`` (dicts that replace the files') are for the tests, which run
    the harness on the CPU at small sizes; ``hook(pipeline)`` may break
    the timed path there.
    """
    import torch
    from mebench import frames, power, reference, trace as tr
    from vvc_affine_tpu_torch import kernels
    from vvc_affine_tpu_torch.models.pipeline import (AffineMEPipeline,
                                                      PipelineConfig)
    from vvc_affine_tpu_torch.parallel.mesh import make_mesh
    from vvc_affine_tpu_torch.runtime import tracing
    from vvc_affine_tpu_torch.runtime.reporting import Timing

    bench, wl, cfg_file, mix_file = load_cell(cell)
    cfg = config or cfg_file
    mix = mix or mix_file
    chips = wl["chips"]
    devices = ([torch.device(f"cuda:{i}") for i in range(chips)]
               if device is None else [torch.device(device)] * chips)
    cuda = devices[0].type == "cuda"
    fw, fh = cfg["frame_w"], cfg["frame_h"]

    o, r = frames.stream(fw, fh, mix["frames"], seed, devices[0], mix["motion"])
    orig_np, recon_np = o.cpu().numpy(), r.cpu().numpy()
    del o, r

    pcfg = PipelineConfig(fw, fh, cfg["qp"], extra_iters=cfg["extra_iters"],
                          device=devices[0], engine=cfg["engine"],
                          mesh=make_mesh(devices) if chips > 1 else None)
    n_preds = 4
    timing = None
    rf = None
    if trace:
        class _Quiet(Timing):
            def stamp(self, msg):       # no START/FINISHED lines on stdout
                pass
        timing = _Quiet()
        rf = torch.profiler.record_function
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile_refs = math.ceil(3 / chips)

    def sync():
        if cuda:
            for d in set(devices):
                torch.cuda.synchronize(d)

    st = {"seq": 0, "t_prev": None, "t0": None, "t0_epoch": None,
          "prof": None, "prof_left": 0, "after_prof": False, "n_timing": 0,
          "timed": timing is not None}
    pending, results, window = {}, {}, []
    setup_spans = []
    setup_s = None

    def complete(key):
        nonlocal setup_s
        t = time.perf_counter()
        t_epoch = time.time()
        spans = recorder.drain() if recorder is not None else None
        disp = None
        if st["timed"]:
            disp = sum(s for _, s in timing.events[st["n_timing"]:])
            st["n_timing"] = len(timing.events)
        if st["t0"] is None:                    # set-up
            if spans is not None:
                setup_spans.append(spans)
                if "graphs.capture" in spans["spans"]:
                    # the first replay of each graph, which counts its
                    # nodes, is set-up too in a traced run
                    return
            setup_s = t_epoch - _T_START
            st["t0"], st["t0_epoch"], st["t_prev"] = t, t_epoch, t
            st["cpu0"] = time.process_time()
            kernels.reset_launches()
            return
        rec = {"key": key, "latency_s": t - st["t_prev"], "dispatch_s": disp,
               "timed": st["timed"],
               "profiled": st["prof"] is not None, "after_profile": st["after_prof"]}
        if spans is not None:
            spans["unresolved"] = recorder.unresolved
            rec["spans"] = spans
        window.append(rec)
        st["t_prev"] = t
        st["t_end"], st["t_end_epoch"] = t, t_epoch
        elapsed = t - st["t0"]
        if trace:
            if st["prof"] is not None and "prof_t0" not in st:
                # the first frame-refs under the profiler meet CUPTI's
                # first-use costs: the profile is of the ones after them
                st["warm_left"] -= 1
                if elapsed >= seconds:
                    st["prof"].stop()
                    st["prof"] = None
                elif st["warm_left"] == 0:
                    start_profile()
            elif st["prof"] is not None:
                st["prof_left"] -= 1
                if st["prof_left"] == 0 or elapsed >= seconds:
                    stop_profile()
            elif (not st["timed"] and "profile" not in st
                  and 0.3 * seconds <= elapsed < seconds):
                # CUPTI is initialised here, not in set-up (docstring)
                st["prof"] = torch.profiler.profile(activities=acts)
                st["prof"].start()
                # a reference list's worth of frame-refs, each reference
                # read once more since then; none without CUPTI
                st["warm_left"] = 4
                if not cuda:
                    start_profile()
        if elapsed >= seconds:
            raise _WindowClosed
        if st["timed"] and elapsed >= 0.2 * seconds:
            st["timed"] = False
            raise _Untimed

    def start_profile():
        with rf(tr.START):
            pass
        st["prof_left"] = profile_refs
        st["prof_t0"] = len(window)
        st["launches0"] = dict(kernels.launches)

    def stop_profile():
        with rf(tr.END):
            pass
        sync()
        st["prof"].stop()
        st["profile"] = (st["prof"], len(window) - st["prof_t0"],
                         {k: v - st["launches0"][k] for k, v in kernels.launches.items()})
        st["prof"] = None
        st["after_prof"] = True

    def on_result(res):
        if rf is not None:
            with rf("readback"):
                host = (res.costs.cpu(), res.cpmvs.cpu())
            with rf("callback"):
                take(res, host)
        else:
            take(res, (res.costs.cpu(), res.cpmvs.cpu()))

    def take(res, host):
        key = (st["seq"], res.poc, res.ref_idx)
        got = pending.setdefault(key, {})
        got[res.pred] = host
        if len(got) == n_preds:
            results[key] = pending.pop(key)
            complete(key)

    # the traced run records the port's spans and counters from before the
    # pipeline is built, so that its capture is recorded; a run without the
    # trace never enters a recorder
    with (tracing.record() if trace else contextlib.nullcontext()) as recorder:
        pipe = AffineMEPipeline(pcfg)
        if hook is not None:
            hook(pipe)
        sampler = power.Sampler(power.card_indices(devices)) if cuda else None
        try:
            while True:
                try:
                    t_seq = timing if st["timed"] else None
                    if rf is not None:
                        with rf("encode"):
                            pipe.encode(orig_np, recon_np, on_result, timing=t_seq)
                    else:
                        pipe.encode(orig_np, recon_np, on_result, timing=t_seq)
                except _WindowClosed:
                    break
                except _Untimed:
                    pass
                st["seq"] += 1
                pending.clear()
        finally:
            if sampler is not None:
                samples = sampler.stop()
        if recorder is not None:
            # replays whose events a frame-ref's drain found unfinished:
            # charged to the last frame-ref, the end of their stretch
            sync()
            late = recorder.drain()["device"]
            last = window[-1]["spans"]["device"]
            for card, d in late.items():
                got = last.setdefault(card, {"replays": 0, "s": 0.0})
                got["replays"] += d["replays"]
                got["s"] += d["s"]
    n = len(window)
    launches = {k: v / max(n, 1) for k, v in kernels.launches.items() if v}
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) if cuda else 0
    window_s = st["t_end"] - st["t0"]
    print(f"[window] {n} frame-refs in {window_s:.6f} s after a set-up of "
          f"{setup_s:.6f} s; process CPU {time.process_time() - st['cpu0']:.3f} s "
          f"in the window; kernel launches per frame-ref {launches}; "
          f"peak allocated {peak} B", file=sys.stderr)

    lat = [w["latency_s"] for w in window]
    if n >= 4:
        q = statistics.quantiles(lat, n=20, method="inclusive")
        staged = sorted(w["latency_s"] for w in window if w["key"][2] == 0)
        print(f"[latency] ms p50 {q[9] * 1e3:.3f} p75 {q[14] * 1e3:.3f} "
              f"p90 {q[17] * 1e3:.3f} p95 {q[18] * 1e3:.3f} max "
              f"{max(lat) * 1e3:.3f}; the {len(staged)} that staged a frame "
              f"(ref 0): median {staged[len(staged) // 2] * 1e3:.3f}; the "
              f"others: median {statistics.median(w['latency_s'] for w in window if w['key'][2]) * 1e3:.3f}",
              file=sys.stderr)

    metrics = {}
    if not trace:
        metrics["frame_refs_per_s"] = n / window_s
        metrics["frame_ref_p90_ms"] = (statistics.quantiles(
            lat, n=10, method="inclusive")[8] * 1e3 if n >= 2 else lat[0] * 1e3)
        metrics["setup_s"] = setup_s
        if sampler is not None:
            joules = 0.0
            lines = power.card_lines(sampler.indices)
            for idx, line in zip(sampler.indices, lines):
                j, k, med, mhz = power.energy(samples[idx], st["t0_epoch"],
                                              st["t_end_epoch"])
                joules += j
                print(f"[power] card {idx} ({line}): {k} samples of "
                      f"{sampler.field} in the window, median {med} W, "
                      f"{j} J, median SM clock {mhz} MHz", file=sys.stderr)
            metrics["joules_per_frame_ref"] = joules / n
    else:
        profile = None
        if "profile" in st:
            prof, k, launched = st["profile"]
            profile = tr.summarize(prof.profiler.kineto_results.events(), RANGES)
            profile["frame_refs"] = k
            profile["launches"] = launched
            counted = {n: v for n, v in launched.items() if v}
            seen = {n: tr.op_seconds(profile, lambda o, n=n: n + "_kernel" in o)[0]
                    for n in counted}
            print(f"[profile] {k} frame-refs; kernel launches counted by the "
                  f"program {counted}, seen by the profiler {seen}",
                  file=sys.stderr)
        records = {"config": cfg, "chips": chips, "window": window,
                   "profile": profile, "setup_spans": setup_spans}
        print(f"[spans] set-up over {len(setup_spans)} frame-refs: "
              f"{[d['spans'].get('graphs.capture') for d in setup_spans]} "
              f"capture; graph nodes "
              f"{[g for d in setup_spans for g in d['counters'].get('graphs.nodes', ())]}; "
              f"replay events left unresolved by a window frame-ref's drain: "
              f"{sum(w['spans']['unresolved'] for w in window)}",
              file=sys.stderr)
    del pipe, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: every decision of the sampled frame-refs against the
    # plain reference, computed on the first card
    sample = check_sample([w["key"] for w in window], seed, mix)
    lists = reference.reference_lists(mix["frames"])
    diff = 0
    failed = 0
    for seq, poc, ref_idx in sample:
        label = lists[poc][ref_idx]
        ref = torch.from_numpy(recon_np[label].astype("int32").reshape(-1)).to(devices[0])
        orig = torch.from_numpy(orig_np[poc - 1].astype("int32").reshape(-1)).to(devices[0])
        want = reference.frame_ref(ref, orig, fw, fh,
                                   reference.lambda_for(cfg["qp"], poc),
                                   extra_iters=cfg["extra_iters"])
        got = results[(seq, poc, ref_idx)]
        d = sum(differing(got[p], want[reference.PREDS[p]]) for p in range(4))
        diff += d
        failed += d > 0
        print(f"[check] POC {poc} ref {ref_idx} (sequence {seq}): {d} CU "
              f"decisions differ", file=sys.stderr)
    wanted = mix["check"]["early"] + mix["check"]["steady"]
    checks = {"differing_decisions": {"value": diff, "limit": 0},
              "frame_refs_not_checked": {"value": wanted - len(sample), "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": correct, "attempted": n, "failed": failed}
    entries = cell_metrics(bench, cell, trace)
    if not trace:
        out["metrics"] = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                          for m in entries if m["name"] in metrics}
    else:
        vals = {}
        for m in entries:
            v = metric_reader(m["name"])(records)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = vals
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
        "count": chips, "memory_peak_bytes": peak}
    if trace and records["profile"] is not None:
        cards = records["profile"]["cards"]
        out["device"]["busy_s"] = (sum(c["busy_s"] for c in cards) / len(cards)
                                   if cards else 0.0)
        out["device"]["window_s"] = records["profile"]["window_s"]
        out["breakdown"] = tr.breakdown(records["profile"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    _, wl, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        print(f"refused: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
