"""The traced run reads the port's recorder (``runtime.tracing``): the
readers of its spans and counters on records made by hand, the first idle
gap of a profile, and a whole traced run on the CPU, where the drains
reach the records, against a run without the trace, which enters no
recorder."""

import pytest
import torch

from mebench import run, trace
from vvc_affine_tpu_torch.runtime import tracing

torch.set_num_threads(2)

SPAN_METRICS = ("graphs.nodes_per_frame_ref", "graphs.capture_s",
                "pipeline.put_ms", "pipeline.put_ms.split",
                "mesh.card_busy_share")


def _drain(put_s=None, nodes=None, device=None):
    spans = {"pipeline.dispatch": {"count": 2, "host_s": 0.004}}
    if put_s is not None:
        spans["pipeline.put"] = {"count": 2, "host_s": put_s}
    counters = {} if nodes is None else {"graphs.nodes_replayed": nodes}
    return {"spans": spans, "device": device or {}, "counters": counters,
            "unresolved": 0}


def _frame_ref(key, latency_s, spans, timed=False, profiled=False):
    return {"key": key, "latency_s": latency_s, "dispatch_s": None,
            "timed": timed, "profiled": profiled, "after_profile": False,
            "spans": spans}


def _records(chips=1):
    cards = [f"cuda:{i}" for i in range(chips)]
    busy = lambda s: {c: {"replays": 2, "s": s * (i + 1)} for i, c in enumerate(cards)}
    window = [
        # timed and profiled frame-refs are not read
        _frame_ref((0, 5, 0), 0.5, _drain(0.9, 999, busy(0.4)), timed=True),
        _frame_ref((0, 5, 1), 0.5, _drain(None, 999, busy(0.4)), profiled=True),
        _frame_ref((1, 1, 0), 0.1, _drain(0.003, 1000, busy(0.02))),
        _frame_ref((1, 2, 0), 0.1, _drain(0.005, 1000, busy(0.02))),
        _frame_ref((1, 2, 1), 0.2, _drain(None, 1000, busy(0.04))),
    ]
    setup = [{"spans": {"graphs.capture": {"count": 2, "host_s": 1.5}},
              "device": {}, "counters": {}},
             {"spans": {}, "device": {}, "counters": {}}]
    return {"config": {"engine": "plane", "frame_w": 256, "frame_h": 128,
                       "extra_iters": 0},
            "chips": chips, "window": window, "profile": None,
            "setup_spans": setup}


def test_readers_of_the_recorder():
    one = _records(1)
    assert run.metric_reader("graphs.nodes_per_frame_ref")(one) == 1000
    assert run.metric_reader("graphs.capture_s")(one) == 1.5
    assert run.metric_reader("pipeline.put_ms")(one) == pytest.approx(4.0)
    assert run.metric_reader("pipeline.put_ms.split")(one) is None
    assert run.metric_reader("mesh.card_busy_share")(one) is None
    four = _records(4)
    assert run.metric_reader("pipeline.put_ms")(four) is None
    assert run.metric_reader("pipeline.put_ms.split")(four) == pytest.approx(4.0)
    # cards busy 20, 40, 60 and 80% of the 0.4 s: the mean, 50%
    assert run.metric_reader("mesh.card_busy_share")(four) == pytest.approx(50.0)


@pytest.mark.parametrize("chips", [1, 4])
def test_readers_of_the_recorder_skip_runs_without_it(chips):
    """A run without the recorder, or one on the CPU (no graph, no replay
    event), gives these readers nothing to read: they return None."""
    rec = _records(chips)
    for f in rec["window"]:
        f.pop("spans")
    rec["setup_spans"] = []
    for name in SPAN_METRICS:
        assert run.metric_reader(name)(rec) is None
    cpu = _records(chips)
    for f in cpu["window"]:
        f["spans"]["counters"] = {}
        f["spans"]["device"] = {}
    cpu["setup_spans"] = [{"spans": {}, "device": {}, "counters": {}}]
    for name in ("graphs.nodes_per_frame_ref", "graphs.capture_s",
                 "mesh.card_busy_share"):
        assert run.metric_reader(name)(cpu) is None


class _Event:
    def __init__(self, name, start, dur, device=False):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return False

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_index(self):
        return 0


def test_first_idle_gap_goes_to_the_first_range_after_it():
    """The profile starts inside ranges it never saw: its first gap is
    charged to the first range entered after the window opens, not to
    ``encode.other``."""
    events = [_Event(trace.START, 100, 1), _Event("pipeline.lambda", 120, 20),
              _Event("pipeline.dispatch", 150, 150),
              _Event("graphs.replay", 160, 30),
              _Event("kernel", 200, 50, device=True), _Event(trace.END, 400, 1)]
    prof = trace.summarize(events, run.RANGES)
    assert prof["idle_by_range"] == pytest.approx(
        {"pipeline.lambda": 100e-9, "pipeline.dispatch": 150e-9})
    assert prof["cards"][0]["busy_s"] == pytest.approx(50e-9)


def _small(cell, fw=256):
    _, _, cfg, mix = run.load_cell(cell)
    cfg = dict(cfg, frame_w=fw, frame_h=128)
    mix = dict(mix, frames=5, check={"early": 1, "steady": 0})
    return cfg, mix


def _spy(monkeypatch):
    """Every ``tracing.record()`` entered, and the records every reader
    is given."""
    seen = {"recorders": [], "records": []}
    real_record, real_reader = tracing.record, run.metric_reader

    def record():
        seen["recorders"].append(True)
        return real_record()

    def reader(name):
        read = real_reader(name)

        def spying(rec):
            seen["records"].append(rec)
            return read(rec)
        return spying

    monkeypatch.setattr(tracing, "record", record)
    monkeypatch.setattr(run, "metric_reader", reader)
    return seen


def test_traced_run_drains_the_recorder(monkeypatch):
    """At 256x128 on the CPU: the set-up's drain is kept as
    ``setup_spans``, every window frame-ref carries its own drain as
    ``spans``, and a frame-ref that staged a frame carries its
    ``pipeline.put``."""
    seen = _spy(monkeypatch)
    cfg, mix = _small("b1080_ld4_plane")
    out = run.run_cell("b1080_ld4_plane", 2**31 + 21, 12.0, True,
                       device="cpu", config=cfg, mix=mix)
    assert out["correct"] and seen["recorders"] == [True]
    assert tracing.active is None
    rec = seen["records"][0]
    assert len(rec["setup_spans"]) == 1      # nothing to capture on the CPU
    assert "pipeline.put" in rec["setup_spans"][0]["spans"]
    assert rec["window"] and all("spans" in f for f in rec["window"])
    for f in rec["window"]:
        assert f["spans"]["spans"]["pipeline.dispatch"]["count"] == 2
        assert ("pipeline.put" in f["spans"]["spans"]) == (f["key"][2] == 0)
        assert f["spans"]["unresolved"] == 0


def test_untraced_run_enters_no_recorder(monkeypatch):
    seen = _spy(monkeypatch)
    cfg, mix = _small("b1080_ld4_plane", fw=128)
    out = run.run_cell("b1080_ld4_plane", 2**31 + 23, 4.0, False,
                       device="cpu", config=cfg, mix=mix)
    assert out["correct"] and seen["recorders"] == [] and seen["records"] == []
