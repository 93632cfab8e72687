"""BENCHMARK.json is the manifest: every cell's configuration, mix and
per-layer metric is a file of its own that the harness finds by name, and
the manifest keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from mebench import run

ROOT = os.path.dirname(run.HERE)
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("mebench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    bench, wl, cfg, mix = run.load_cell(cell, ROOT)
    assert cfg["name"] == wl["config"] and mix["name"] == wl["traffic"]
    assert cfg["cards"] == wl["chips"] and cfg["engine"] in ("plane", "gather")
    e2e = run.cell_metrics(bench, cell, trace=False)
    layer = run.cell_metrics(bench, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(run.metric_reader(metric))
    assert set(m["workloads"]) <= set(CELLS)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_config_files_are_the_manifests():
    for c in BENCH["configs"]:
        cfg = run.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["source"]) <= 200


def test_readers_skip_what_they_cannot_read():
    """A reader that finds nothing returns None, never 0."""
    rec = {"config": {"engine": "plane", "frame_w": 256, "frame_h": 128},
           "chips": 1, "window": [], "profile": None}
    for m in BENCH["per_layer"]:
        assert run.metric_reader(m["name"])(rec) is None
