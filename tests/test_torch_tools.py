"""The port's measurement tools (``vvc_affine_tpu_torch/tools/``) on the CPU.

* Every tool refuses a flag it does not know, and the JAX tools' TPU knobs.
* ``energy_report`` prints the JAX ``tools/energy_report.py``'s lines (that
  tool is plain Python, loaded here by path) on a power-less trace, and
  adds the right joules on a trace with power (checked by hand).
* ``power_trace`` runs a command under a fake ``nvidia-smi`` first on
  ``PATH``, samples the card the command runs on (matched by UUID, not by
  index), and writes a trace the JAX analyzer parses.
* The ``xprof_trace`` summarizer charges device self time on a small
  hand-written Chrome trace with nested, overlapping and host events.
* ``profile_stage``'s profiler reading on a few ops.
* ``tpu_parity``, ``gop_golden`` and ``scaling_bench`` end to end with
  ``device="cpu"`` at 256x128, their children on the CPU; without ``--out``
  they write into the temporary directory.
"""

import contextlib
import importlib.util
import io
import json
import os
import stat
import sys
import tempfile
import time
import types

import pytest
import torch

from vvc_affine_tpu_torch.tools import (energy_report, gop_golden,
                                        mosaic_probe, power_trace,
                                        profile_stage, scaling_bench,
                                        tpu_parity, xprof_trace)

# One intra-op thread: the suite runs several pytest workers at once, and
# the tools' CPU children take this process's thread count.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = {"power_trace": power_trace, "energy_report": energy_report,
         "profile_stage": profile_stage, "xprof_trace": xprof_trace,
         "tpu_parity": tpu_parity, "gop_golden": gop_golden,
         "scaling_bench": scaling_bench, "mosaic_probe": mosaic_probe}

# each JAX tool's TPU knobs (tools/profile_stage.py:63-75,
# tools/xprof_trace.py:46-54, tools/tpu_parity.py:80-88)
_KNOBS = ("--mxu", "--no-mxu", "--i16taps", "--f32", "--rebase", "--mom",
          "--fused")
REFUSED = ([(name, ["--bogus"]) for name in TOOLS]
           + [("profile_stage", [k]) for k in _KNOBS]
           + [("xprof_trace", [k]) for k in _KNOBS[:-1]]
           + [("tpu_parity", [k]) for k in _KNOBS[:5]]
           + [("gop_golden", ["--fram", "2"]),          # no abbreviations
              ("power_trace", ["--bogus", "--", "true"]),
              ("scaling_bench", ["--chips", "1,x"]),
              ("profile_stage", ["19x"])])


@pytest.mark.parametrize("name,argv", REFUSED,
                         ids=[f"{n}{''.join(a)}" for n, a in REFUSED])
def test_tools_refuse_unknown_flags(name, argv, capsys):
    """argparse exits 2 before the tool reads or runs anything (no card
    is asked for: the refusal comes first)."""
    with pytest.raises(SystemExit) as e:
        TOOLS[name].main(argv, device="cpu")
    assert e.value.code == 2
    assert "error" in capsys.readouterr().err


def _jax_energy_report():
    spec = importlib.util.spec_from_file_location(
        "jax_energy_report", os.path.join(_REPO, "tools", "energy_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report(mod, trace, log):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(["--trace", str(trace), "--log", str(log)]) == 0
    return buf.getvalue().splitlines()


_LOG = """START HOST,100.000000,
START READ .csv,100.100000,
FINISHED READ .csv,100.300000,
START EXEC FULL_2CP+FULL_3CP POC 1 ref 0,100.400000,
Reporting results POC=1 refIdx=0 PredType=0
FINISHED EXEC FULL_2CP+FULL_3CP POC 1 ref 0,101.000000,
START EXEC HALF_2CP+HALF_3CP POC 1 ref 0,101.050000,
FINISHED EXEC HALF_2CP+HALF_3CP POC 1 ref 0,101.900000,
START EXEC FULL_2CP+FULL_3CP POC 2 ref 1,102.000000,
FINISHED EXEC FULL_2CP+FULL_3CP POC 2 ref 1,102.500000,
FINISHED HOST,103.000000,
"""


def test_energy_report_matches_jax_without_power(tmp_path):
    """A trace without a power column (the port's tracer on the CPU, the
    CLI's --DeviceTrace): the port's report is the JAX report, line for
    line, and nothing more."""
    trace = tmp_path / "trace.csv"
    rows = ["t_epoch,bytes_in_use,peak_bytes_in_use"]
    rows += [f"{100 + 0.05 * i:.6f},{1000 * (i % 7)},{6000}"
             for i in range(62)]
    trace.write_text("\n".join(rows) + "\n\nmarker,t_epoch\nSTART HOST,"
                     "100.000000\n")
    log = tmp_path / "run.log"
    log.write_text(_LOG)
    want = _report(_jax_energy_report(), trace, log)
    assert len(want) == 8
    assert _report(energy_report, trace, log) == want


def test_energy_report_joules_by_hand(tmp_path):
    """Three samples, two readings, one EXEC phase around them all:
    mean (100 + 200 + 200) / 3 W over 1.0 s; a phase with no sample adds
    nothing; the JAX lines come first."""
    trace = tmp_path / "trace.csv"
    trace.write_text("t_epoch,bytes_in_use,peak_bytes_in_use,power_w\n"
                     "power_field,power.draw.instant\n"
                     "10.0,5,5,100.0\n10.5,7,7,200.0\n11.0,6,7,200.0\n"
                     "\nmarker,t_epoch\n")
    log = tmp_path / "run.log"
    log.write_text("START EXEC FULL_2CP+FULL_3CP POC 1 ref 0,10.000000,\n"
                   "FINISHED EXEC FULL_2CP+FULL_3CP POC 1 ref 0,11.000000,\n"
                   "START EXEC HALF_2CP+HALF_3CP POC 1 ref 0,11.100000,\n"
                   "FINISHED EXEC HALF_2CP+HALF_3CP POC 1 ref 0,11.200000,\n")
    got = _report(energy_report, trace, log)
    want = _report(_jax_energy_report(), trace, log)
    assert got[:len(want)] == want
    assert got[len(want):] == [
        "power: power.draw.instant, 3 samples, 2 distinct readings, "
        "max 200.00 W",
        "phase,mean_power_w,energy_j,distinct_power_readings,frame_refs,"
        "joules_per_frame_ref",
        "EXEC FULL_2CP+FULL_3CP POC 1 ref 0,166.667,166.666667,2,,",
        "EXEC HALF_2CP+HALF_3CP POC 1 ref 0,,,0,,",
        "TOTAL_EXEC,166.667,166.666667,2,1,166.666667",
    ]


# a fake nvidia-smi: two cards; "-lms" streams samples until it is killed
_FAKE_SMI = """#!{python}
import sys, time, datetime
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if "--help-query-gpu" in args:
    print('"power.draw"\\n"power.draw.average"\\n"power.draw.instant"')
elif "--query-gpu=index,uuid" in args:
    print("0, GPU-aaaaaaaa-0000\\n1, GPU-bbbbbbbb-1111")
elif "-lms" in args:
    assert args[args.index("-i") + 1] == "1", args
    k = 0
    while True:
        now = datetime.datetime.now().strftime("%Y/%m/%d %H:%M:%S.%f")[:-3]
        print(f"{{now}}, {{100 + k % 3}}, {{150.0 + 25 * (k % 2):.2f}}",
              flush=True)
        k += 1
        time.sleep(0.002)
else:
    sys.exit(9)
"""


def test_power_trace_under_a_fake_nvidia_smi(tmp_path, monkeypatch, capfd):
    """The command's card is CUDA device 0, whose UUID is nvidia-smi's
    card 1: the tool samples card 1, takes the instant power field, writes
    MiB as bytes, and passes the command's stamps and exit code on.  The
    JAX parser reads the trace, and the port's report adds power."""
    calls = tmp_path / "calls.txt"
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    smi.write_text(_FAKE_SMI.format(python=sys.executable, log=str(calls)))
    smi.chmod(smi.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{smi.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            uuid="BBBBBBBB-1111"))
    cmd = ("import time\n"
           "def st(m):\n"
           "    t = time.time(); print(f'{m},{int(t)}.{int(t % 1 * 1e6):06d},',"
           " flush=True)\n"
           "st('START EXEC FULL_2CP+FULL_3CP POC 1 ref 0'); time.sleep(0.3)\n"
           "st('FINISHED EXEC FULL_2CP+FULL_3CP POC 1 ref 0')\n"
           "raise SystemExit(3)\n")
    trace = tmp_path / "trace.csv"
    rc = power_trace.main(["--out", str(trace), "--period-ms", "2", "--",
                           sys.executable, "-c", cmd])
    out = capfd.readouterr().out
    assert rc == 3
    assert "START EXEC FULL_2CP+FULL_3CP POC 1 ref 0," in out
    lms = [ln for ln in calls.read_text().splitlines() if "-lms" in ln]
    assert lms == ["-i 1 --query-gpu=timestamp,memory.used,"
                   "power.draw.instant --format=csv,noheader,nounits "
                   "-lms 2"]
    lines = trace.read_text().splitlines()
    assert lines[:2] == ["t_epoch,bytes_in_use,peak_bytes_in_use,power_w",
                         "power_field,power.draw.instant"]
    assert [ln.split(",")[0] for ln in lines[-3:]] == [
        "marker", "START EXEC FULL_2CP+FULL_3CP POC 1 ref 0",
        "FINISHED EXEC FULL_2CP+FULL_3CP POC 1 ref 0"]
    jax_rows = _jax_energy_report().parse_trace(str(trace))
    rows, field = energy_report.parse_trace(str(trace))
    assert field == "power.draw.instant" and len(rows) > 20
    assert jax_rows == [r[:3] for r in rows]
    assert {r[1] for r in rows} <= {m * 2**20 for m in (100, 101, 102)}
    assert rows[-1][2] == max(r[1] for r in rows)
    assert {r[3] for r in rows} == {150.0, 175.0}
    log = tmp_path / "run.log"
    log.write_text(out)
    got = _report(energy_report, trace, log)
    total = got[-1].split(",")
    assert total[0] == "TOTAL_EXEC" and total[4] == "1"
    assert 150 <= float(total[1]) <= 175 and float(total[3]) == 2


def test_power_trace_on_the_cpu(tmp_path, capfd):
    """With ``device="cpu"`` there is no card: the host clock alone, zero
    bytes, no power column value, and the JAX report of it."""
    trace = tmp_path / "trace.csv"
    cmd = ("import time; t = time.time(); "
           "print(f'START EXEC X POC 1 ref 0,{int(t)}.{int(t % 1 * 1e6):06d},')"
           "; time.sleep(0.05); t = time.time(); "
           "print(f'FINISHED EXEC X POC 1 ref 0,{int(t)}.{int(t % 1 * 1e6):06d},')")
    assert power_trace.main(["--out", str(trace), "--", sys.executable, "-c",
                             cmd], device="cpu") == 0
    log = tmp_path / "run.log"
    log.write_text(capfd.readouterr().out)
    rows, field = energy_report.parse_trace(str(trace))
    assert field is None and rows
    assert all(r[1:] == (0, 0, None) for r in rows)
    assert _report(energy_report, trace, log) == _report(
        _jax_energy_report(), trace, log)


def _x(name, ts, dur, cat="kernel", tid=7, pid=0):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": pid, "tid": tid}


def test_xprof_summary_charges_device_self_time():
    """Device lanes are kernel/memcpy/memset events per (pid, tid): a
    nested event is charged to itself and taken off its parent, two lanes
    overlap in the busy union, host events (``cpu_op``, the
    ``frame_ref`` annotation, runtime calls) are never device time."""
    trace = {"traceEvents": [
        _x("frame_ref", 0, 1000, cat="user_annotation", tid=1),
        _x("aten::add", 10, 900, cat="cpu_op", tid=1),
        _x("cudaLaunchKernel", 20, 5, cat="cuda_runtime", tid=1),
        _x("frame_ref", 0, 1000, cat="gpu_user_annotation"),
        _x("void warp_kernel<8>(int const*)", 100, 50),
        _x("outer", 200, 100),
        _x("Memset (Device)", 220, 30, cat="gpu_memset"),
        _x("blockreduce_kernel(short const*)", 400, 40),
        _x("blockreduce_kernel(short const*)", 420, 60, tid=9),
        _x("Memcpy DtoH (Device -> Pinned)", 600, 10, cat="gpu_memcpy"),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU"}},
    ]}
    s = xprof_trace.summarize(trace)
    ops = {name: (ms, n) for name, ms, n in s["top_ops"]}
    assert ops == {"outer": (0.07, 1),
                   "void warp_kernel<8>(int const*)": (0.05, 1),
                   "Memset (Device)": (0.03, 1),
                   "blockreduce_kernel(short const*)": (0.1, 2),
                   "Memcpy DtoH (Device -> Pinned)": (0.01, 1)}
    assert s["device_launches"] == 6
    # busy: 50 + 100 + [400, 480) + 10 = 240 us of the 1000 us window
    assert s["device_busy_ms"] == pytest.approx(0.24)
    assert s["window_ms"] == 1.0
    assert s["busy_share"] == pytest.approx(0.24)
    assert s["hand_written_launches"] == {"K1": 1, "K2": 2}
    assert s["hand_written_ms"] == {"K1": 0.05, "K2": 0.1}


def test_profile_stage_reads_the_profiler():
    """Two top-level aten ops inside the piece (one with an aten child),
    no device launch on the CPU, a share of the host time in (0, 1]."""
    a = torch.arange(64, dtype=torch.int32)

    def piece():
        b = a + 1
        return torch.cumsum(b.reshape(8, 8), 1)

    r = profile_stage.profiled(piece, torch.device("cpu"))
    assert r["device_launches"] == 0 and r["device_ms"] == 0
    assert r["aten_ops"] == 3                  # add, reshape (view), cumsum
    assert 0 < r["aten_share"] <= 1


def test_profile_stage_device_events_skip_the_range():
    """The GPU side of the piece's own profiler range spans the whole run:
    it is neither a launch nor device time; host events are neither."""
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    events = [types.SimpleNamespace(name=n, device_type=d)
              for n, d in ((profile_stage.RANGE, cuda),
                           (profile_stage.RANGE, cpu),
                           ("warp_kernel", cuda), ("aten::add", cpu),
                           ("Memset (Device)", cuda))]
    assert [e.name for e in profile_stage.device_events(events)] == [
        "warp_kernel", "Memset (Device)"]


def test_tpu_parity_on_the_cpu(tmp_path, capsys):
    """Card side and golden child both on the CPU: every stage of the
    chain bit-identical, the report written with the JAX report's keys."""
    out = tmp_path / "parity.json"
    assert tpu_parity.main(["256x128", "--out", str(out)],
                           device="cpu") == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["backend"] == "cpu"
    assert report["device"] == "cpu" and report["resolution"] == "256x128"
    assert sorted(report["stages"]) == sorted(
        f"{m}_{n}_{k}" for m in ("full", "half") for n in (2, 3)
        for k in ("cost", "cpmvs"))
    assert set(report["stages"].values()) == {"bit-identical"}
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"tpu_parity": report}


def test_gop_golden_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both engines' CLI children on the CPU: 40 byte-identical logs, no
    kernel launch, the artifact in the temporary directory (no --out)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert gop_golden.main(["256x128"], device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    assert len(path) == 1 and path[0].startswith("gop_golden_")
    artifact = json.loads((tmp_path / path[0]).read_text())
    assert summary["gop_golden"] == {k: v for k, v in artifact.items()
                                     if k != "files"}
    assert artifact["verdict"] == "byte-identical"
    assert artifact["n_log_files"] == len(artifact["files"]) == 40
    assert all(f["match"] for f in artifact["files"].values())
    for engine in ("plane", "gather"):
        assert set(artifact["launches"][engine].values()) == {0}
        assert artifact["max_memory_allocated"][engine] is None
        assert list(artifact["frame_ref_s"][engine]) == ["POC 1 ref 0"]
        assert artifact["first_frame_ref_s"][engine] == list(
            artifact["frame_ref_s"][engine].values())
        assert artifact["later_frame_ref_s"][engine] == []


def test_gop_golden_diff_finds_a_differing_log(tmp_path):
    """One byte off, and one log written by one engine only: both count."""
    for engine in ("plane", "gather"):
        (tmp_path / f"{engine}__a.csv").write_bytes(b"1,2\n")
        (tmp_path / f"{engine}__b.csv").write_bytes(
            b"3,4\n" if engine == "plane" else b"3,5\n")
    (tmp_path / "plane__c.csv").write_bytes(b"")
    verdict, n, files = gop_golden.diff_logs(str(tmp_path))
    assert (verdict, n) == ("MISMATCH", 3)
    assert files["_a.csv"]["match"] and not files["_b.csv"]["match"]
    assert files["_c.csv"] == {"match": False, "only_in": "plane"}


def test_scaling_bench_on_the_cpu(capsys):
    """1 and 2 CPU shards: one line each with the JAX tool's fields,
    ``devices`` and equal result digests."""
    t0 = time.time()
    assert scaling_bench.main(["256x128", "--chips", "1,2"],
                              device="cpu") == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [ln["chips"] for ln in lines] == [1, 2]
    assert [ln["devices"] for ln in lines] == [["cpu"], ["cpu", "cpu"]]
    assert len({ln["results_sha256"] for ln in lines}) == 1
    for ln in lines:
        assert {"mode", "resolution", "sec_per_stage", "cus_per_sec",
                "baseline_chips", "speedup_vs_baseline",
                "efficiency"} <= set(ln)
        assert 0 < ln["sec_per_stage"] < time.time() - t0
    assert lines[0]["efficiency"] == lines[0]["speedup_vs_baseline"] == 1.0
