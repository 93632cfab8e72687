"""The harness drives a whole run (stream, pipeline, window, readback,
check) on the CPU at 256x128 (the sound run at 128x128, to reach a steady
frame-ref sooner), without its look for a card, and sees
``correct`` come out false when the timed path is broken underneath: a
stage that returns its state (the CPMVs) unchanged, half of the CTUs left
out, the exchange between cards left out (the split's join), and one
answer altered where it is produced.  A run with nothing broken is
correct."""

import pytest
import torch

from mebench import run
from vvc_affine_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)


def _small(cell, fw):
    _, _, cfg, mix = run.load_cell(cell)
    cfg = dict(cfg, frame_w=fw, frame_h=128)
    mix = dict(mix, frames=5, check={"early": 1, "steady": 1})
    return cfg, mix


def _run(cell, hook=None, seconds=8.0, fw=256, seed=2**31 + 3):
    cfg, mix = _small(cell, fw)
    return run.run_cell(cell, seed, seconds, False, device="cpu", config=cfg,
                        mix=mix, hook=hook)


def _wrap_pairs(pipe, change):
    for mode, fn in list(pipe.pairs.items()):
        def broken(ref, orig, lam, prev, _fn=fn, _mode=mode):
            return change(_mode, prev, *_fn(ref, orig, lam, prev))
        pipe.pairs[mode] = broken


def state_unchanged(pipe):
    _wrap_pairs(pipe, lambda mode, prev, c2, p2, c3, p3:
                (c2, prev.clone(), c3, prev.clone()))


def half_left_out(pipe):
    def change(mode, prev, *outs):
        outs = [o.clone() for o in outs]
        for o in outs:
            o[o.shape[0] // 2:] = 0
        return tuple(outs)
    _wrap_pairs(pipe, change)


def answer_altered(pipe):
    def change(mode, prev, c2, p2, c3, p3):
        if mode == "full":
            c2 = c2.clone()
            c2[0, 0] += 1
        return c2, p2, c3, p3
    _wrap_pairs(pipe, change)


def test_sound_run_is_correct():
    out = _run("b1080_ld4_plane", seconds=20.0, fw=128)
    assert out["checks"]["frame_refs_not_checked"]["value"] == 0
    assert out["correct"] and out["checks"]["differing_decisions"]["value"] == 0
    assert set(out["metrics"]) == {"frame_refs_per_s", "frame_ref_p90_ms", "setup_s"}


@pytest.mark.parametrize("cell,fw,steady,host_metrics", [
    ("b1080_ld4_plane", 128, 1, {"pipeline.dispatch_ms", "pipeline.outside_dispatch_ms",
                                 "pipeline.put_ms"}),
    ("a2160_ld4_split4", 256, 0, {"pipeline.dispatch_ms", "pipeline.outside_dispatch_ms.split",
                                  "pipeline.put_ms.split"}),
])
def test_traced_run_on_the_cpu(cell, fw, steady, host_metrics):
    """The traced run: ``Timing`` in the first half of the window, the
    profile in the second, untimed half; the pipeline's metrics and the
    port's staging spans are read and the check is the same.  (The CPU
    has no device lane and no CUDA graph, so the device metrics and the
    graphs' are left out here; the split on the CPU is too slow to reach
    a frame-ref with four references in the window.)"""
    cfg, mix = _small(cell, fw)
    mix["check"] = {"early": 1, "steady": steady}
    out = run.run_cell(cell, 2**31 + 7, 40.0, True, device="cpu",
                       config=cfg, mix=mix)
    assert out["correct"] and out["checks"]["frame_refs_not_checked"]["value"] == 0
    assert set(out["metrics"]) == host_metrics
    assert "window_s" in out["device"] and "breakdown" in out


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    out = _run("b1080_ld4_plane", hook=fault)
    assert not out["correct"] and out["checks"]["differing_decisions"]["value"] > 0


def test_split_without_exchange_is_caught(monkeypatch):
    def first_shard_only(self, outs):
        first = self.devices[0]
        joined = [torch.cat([parts[0].to(first)]
                            + [torch.zeros_like(o).to(first) for o in parts[1:]])
                  for parts in zip(*outs)]
        return tuple(x[:self.n_ctus] for x in joined)
    monkeypatch.setattr(pmesh._Split, "join", first_shard_only)
    out = _run("a2160_ld4_split4")
    assert not out["correct"] and out["checks"]["differing_decisions"]["value"] > 0
