"""The port's span-and-counter recorder (``runtime/tracing.py``) on the CPU.

* Off (the default), a span site does nothing: every site gets the same
  no-op object, and under ``torch.profiler`` no port range appears.
* On, the pipeline's and the split's spans carry their ``poc`` /
  ``ref_idx`` / ``mode`` / ``card``, nest (the split's ``mesh.*`` under
  ``pipeline.dispatch``), and one drain per frame-ref returns what closed
  since the one before.
* ``pipeline.bytes_staged`` is the frames' bytes times the distinct
  devices, in one pipeline and on a mesh that names the CPU twice (one
  distinct device, so one ``mesh.issue`` per dispatch).
* Under ``torch.profiler`` the port's span names are ranges.
* A drain resolves only the replay events that have completed and carries
  the others over, with nothing waited on.
* The decisions are bit-identical with the recorder on and off.

The CPU has no CUDA graphs, so the ``graphs.*`` spans, the node counts and
the replay events are checked on the card (``chip_smoke.py``, phase 14).
One 128x128 FULL-only pipeline serves the module.
"""

import pytest
import torch

from vvc_affine_tpu_torch import testing
from vvc_affine_tpu_torch.models.pipeline import (AffineMEPipeline,
                                                  PipelineConfig)
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.runtime import tracing

torch.set_num_threads(1)

FW = FH = 128
FRAME_BYTES = FW * FH * 4
PORT_RANGES = ("pipeline.", "mesh.", "graphs.")


def _pipe(mesh=None):
    return AffineMEPipeline(PipelineConfig(FW, FH, 32, device="cpu",
                                           test_half=False, mesh=mesh))


def _run(pipe, frames, record):
    """The pipeline's results; with ``record``, also per frame-ref (after
    its last decision) the spans closed so far and the drain."""
    orig, recon = frames
    per_ref = []
    if not record:
        return pipe.encode(orig, recon), per_ref
    with tracing.record() as rec:
        def on_result(r):
            if r.pred == 1:          # FULL 3CP, a frame-ref's last
                per_ref.append((r.poc, r.ref_idx, list(rec.spans),
                                rec.drain()))
        out = pipe.encode(orig, recon, on_result)
    assert tracing.active is None
    return out, per_ref


@pytest.fixture(scope="module")
def frames():
    return testing.affine_gop(FW, FH, 2, seed=5)


@pytest.fixture(scope="module")
def runs(frames):
    pipe = _pipe()
    off, _ = _run(pipe, frames, False)
    on, per_ref = _run(pipe, frames, True)
    return off, on, per_ref


@pytest.fixture(scope="module")
def split(frames):
    """One frame on a mesh that names the CPU twice; the per-device runner
    is wrapped to keep its last outputs (the profiler test replays
    them)."""
    pipe = _pipe(pmesh.make_mesh(["cpu", "cpu"]))
    per_device = pipe.pairs["full"].per_device
    (dev, real), = per_device.items()
    last = {}

    def keep(*args):
        last["out"] = real(*args)
        return last["out"]

    per_device[dev] = keep
    one = tuple(f[:1] for f in frames)
    out, per_ref = _run(pipe, one, True)
    per_device[dev] = lambda *args: last["out"]
    return pipe, one, out, per_ref


def test_off_is_one_noop():
    assert tracing.active is None
    a = tracing.span("pipeline.put")
    assert a is tracing.span("graphs.replay", card="cuda:0", poc=3)
    with a as sp:
        assert not hasattr(sp, "attrs")
    tracing.count("graphs.replays", 1)       # nothing to count into
    tracing.closed("graphs.capture", 0, 1)


def test_outputs_identical_on_and_off(runs):
    off, on, _ = runs
    assert [(r.poc, r.ref_idx, r.pred) for r in off] == \
        [(r.poc, r.ref_idx, r.pred) for r in on]
    for a, b in zip(off, on):
        assert torch.equal(a.costs, b.costs) and torch.equal(a.cpmvs, b.cpmvs)


def test_drain_once_per_frame_ref(runs):
    """POC 1 ref 0, POC 2 refs 0 and 1: each drain holds the frame-ref's
    one pair dispatch and the frames staged for it."""
    _, _, per_ref = runs
    assert [(poc, ref) for poc, ref, _, _ in per_ref] == [(1, 0), (2, 0),
                                                         (2, 1)]
    for poc, ref, spans, agg in per_ref:
        s = agg["spans"]
        assert s["pipeline.dispatch"]["count"] == 1
        assert all(v["host_s"] > 0 for v in s.values())
        assert agg["device"] == {}
        assert sum(v["count"] for v in s.values()) == len(spans)
        staged = agg["counters"].get("pipeline.bytes_staged", {})
        if ref == 0:
            # POC 1: orig 1, recon 0 and the prefetched orig 2; POC 2: recon 1
            n = 3 if poc == 1 else 1
            assert s["pipeline.put"]["count"] == n
            assert s["pipeline.lambda"]["count"] == 1
            assert staged == {"cpu": n * FRAME_BYTES}
        else:
            assert "pipeline.put" not in s and staged == {}


def test_spans_carry_attributes(runs):
    _, _, per_ref = runs
    for poc, ref, spans, _ in per_ref:
        for sp in spans:
            assert sp.end_ns >= sp.start_ns > 0
            if sp.name == "pipeline.dispatch":
                assert sp.attrs == {"poc": poc, "ref_idx": ref,
                                    "mode": "full"}
                assert sp.parent is None
            elif sp.name == "pipeline.put":
                assert sp.attrs == {"nbytes": FRAME_BYTES}
            elif sp.name == "pipeline.lambda":
                assert sp.attrs == {"poc": poc}


def test_split_spans_nest_and_stage_once_per_device(split):
    _, _, _, per_ref = split
    (poc, ref, spans, agg), = per_ref
    assert (poc, ref) == (1, 0)
    issue = [sp for sp in spans if sp.name == "mesh.issue"]
    assert len(issue) == 1 and issue[0].attrs == {"card": "cpu"}
    for sp in spans:
        if sp.name.startswith("mesh."):
            assert sp.parent.name == "pipeline.dispatch"
            assert sp.parent.attrs["poc"] == 1
            assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns \
                <= sp.parent.end_ns
    order = [sp.name for sp in spans if sp.name.startswith("mesh.")]
    assert order == ["mesh.inputs", "mesh.issue", "mesh.join"]
    # one frame: its original and its reference, each on the one device
    assert agg["counters"]["pipeline.bytes_staged"] == {"cpu": 2 * FRAME_BYTES}


def test_split_outputs_equal_one_device(runs, split):
    _, on, _ = runs
    _, _, out, _ = split
    for a, b in zip(on[:2], out):
        assert torch.equal(a.costs, b.costs) and torch.equal(a.cpmvs, b.cpmvs)


def _profiled_names(pipe, one, record):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        if record:
            with tracing.record():
                pipe.encode(*one)
        else:
            pipe.encode(*one)
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_profiler_sees_port_spans_only_when_on(split):
    """The split's per-device run replays its kept outputs, so only the
    port's host work is profiled."""
    pipe, one, _, _ = split
    names = _profiled_names(pipe, one, True)
    port = {n for n in names if n.startswith(PORT_RANGES)}
    assert port == {"pipeline.put", "pipeline.lambda", "pipeline.dispatch",
                    "mesh.inputs", "mesh.issue", "mesh.join"}
    names = _profiled_names(pipe, one, False)
    assert not {n for n in names if n.startswith(PORT_RANGES)}


class _Event:
    def __init__(self, done, ms=0.0):
        self.done, self.ms = done, ms

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms


def test_drain_carries_unfinished_replays_over():
    with tracing.record() as rec:
        done = (_Event(True), _Event(True, 2.5))
        busy = (_Event(True), _Event(False, 4.0))
        rec._pending = [("cuda:0", done), ("cuda:1", busy),
                        ("cuda:0", done)]
        rec._pool = {"cuda:0": [], "cuda:1": []}
        agg = rec.drain()
        assert agg["device"] == {"cuda:0": {"replays": 2, "s": 0.005}}
        assert rec.unresolved == 1 and len(rec._pool["cuda:0"]) == 2
        busy[1].done = True
        assert rec.drain()["device"] == {"cuda:1": {"replays": 1,
                                                    "s": 0.004}}
        assert rec.unresolved == 0
        start, end = rec.replay_events("cuda:1")        # reused
        assert start is busy[0] and end is busy[1]
        with pytest.raises(RuntimeError):
            with tracing.record():
                pass
