"""The PyTorch port's CLI writes the JAX CLI's decision logs byte for byte.

Both CLIs run the default main path (plane engine, fused 2CP->3CP pairs,
FULL and HALF) over a two-frame GOP, and the port's ``--Engine gather``
(four separate stages) must write the same bytes, which covers the reference-buffer
schedule, lambda(QP, POC), the 2CP->3CP chain and the log writer
(main.cpp:578-1010 end to end).  The JAX CLI runs once, in a child process
on the CPU (XLA:CPU needs the raised stack rlimit for stage compiles, see
tests/_child.py); the port runs here with ``device="cpu"``, uninterrupted
and resumed from a checkpoint (after a clean stop, and after a crash in the
middle of a frame).  The port's checkpoint pruning, device trace and memory
report are held against the JAX package's too.  So is the port's
multi-device path: ``--NumChips 2`` on the CPU (the one CTU of the frame
and one padding CTU), and runs of two processes over gloo
(``--Coordinator``), uninterrupted and resumed from a checkpoint, whose
follower writes no file.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._child import _raise_stack
from vvc_affine_tpu_torch import cli as torch_cli
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.runtime import reporting
from vvc_affine_tpu_torch.runtime.checkpoint import CheckpointManager

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(tmp, fw, fh, n):
    """The GOP of tests/test_gop_parity.py: a drifting noisy frame."""
    rng = np.random.default_rng(31)
    base = rng.integers(0, 1024, size=(fh, fw)).astype(np.int32)
    origs, refs = [], [base]
    prev = base
    for _ in range(n):
        o = np.clip(np.roll(prev, (2, -1), axis=(0, 1))
                    + rng.integers(-12, 12, (fh, fw)), 0, 1023)
        origs.append(o)
        refs.append(o)
        prev = o
    opath = os.path.join(tmp, "orig.csv")
    rpath = os.path.join(tmp, "ref.csv")
    frames_io.write_frames_csv(opath, np.stack(origs).astype(np.uint16))
    frames_io.write_frames_csv(rpath, np.stack(refs[:n]).astype(np.uint16))
    return opath, rpath


def _logs(prefix_dir, stem):
    out = {}
    for f in sorted(os.listdir(prefix_dir)):
        if f.startswith(stem + "_"):
            with open(os.path.join(prefix_dir, f), "rb") as fh:
                out[f[len(stem) + 1:]] = fh.read()
    return out


FW, FH, N = 128, 128, 2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI's uninterrupted run over the GOP, once per module: the
    CLI arguments without -f and -l (input CSVs included) and its decision
    logs by name."""
    tmp = str(tmp_path_factory.mktemp("jax_cli"))
    opath, rpath = _fixture(tmp, FW, FH, N)
    args = ["-s", f"{FW}x{FH}", "-q", "32", "-o", opath, "-r", rpath]
    env = dict(os.environ, VVC_AFFINE_TPU_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "vvc_affine_tpu.cli", "-f", str(N), *args,
         "-l", os.path.join(tmp, "jax")],
        env=env, cwd=_REPO, preexec_fn=_raise_stack,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    logs = _logs(tmp, "jax")
    n_logs = sum(len(reporting.log_paths("x", pred)) for pred in range(4))
    assert len(logs) == n_logs
    return args, logs


def test_cli_decision_logs_match_jax(tmp_path, jax_run):
    args, want = jax_run
    assert torch_cli.main(["-f", str(N)] + args
                          + ["-l", str(tmp_path / "torch")],
                          device="cpu") == 0
    got = _logs(str(tmp_path), "torch")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("extra", [[], ["--PerPredTiming"]])
def test_cli_gather_engine_matches_jax(tmp_path, jax_run, extra):
    """``--Engine gather`` (the per-pred timing is its only dispatch, so
    ``--PerPredTiming`` changes nothing) writes the JAX plane logs."""
    args, want = jax_run
    assert torch_cli.main(["-f", str(N)] + args
                          + ["-l", str(tmp_path / "g"), "--Engine", "gather"]
                          + extra, device="cpu") == 0
    assert _logs(str(tmp_path), "g") == want


@pytest.mark.parametrize("extra", [["--PerPredTiming"], ["--SkipHalf"],
                                   ["--SkipFull"]])
def test_cli_options_keep_the_decisions(tmp_path, extra):
    """Per-pred dispatch and skipped modes write the default run's bytes
    for every log they write (the port alone: two CPU runs)."""
    tmp = str(tmp_path)
    opath, rpath = _fixture(tmp, 128, 128, 1)
    args = ["-f", "1", "-s", "128x128", "-q", "27", "-o", opath, "-r", rpath]
    assert torch_cli.main(args + ["-l", os.path.join(tmp, "a")],
                          device="cpu") == 0
    assert torch_cli.main(args + extra + ["-l", os.path.join(tmp, "b")],
                          device="cpu") == 0
    a, b = _logs(tmp, "a"), _logs(tmp, "b")
    skipped = {p[len("x_"):]
               for pred in {"--SkipHalf": (2, 3),
                            "--SkipFull": (0, 1)}.get(extra[0], ())
               for p in reporting.log_paths("x", pred)}
    assert b and set(b) == set(a) - skipped
    assert all(b[k] == a[k] for k in b)


def test_frames_csv_round_trip(tmp_path):
    """write_frames_csv/read_frames_csv agree with the JAX package's."""
    from vvc_affine_tpu.runtime import frames as jax_frames

    rng = np.random.default_rng(4)
    frames = rng.integers(0, 1024, size=(2, 12, 20)).astype(np.uint16)
    path = str(tmp_path / "f.csv")
    frames_io.write_frames_csv(path, frames)
    jpath = str(tmp_path / "j.csv")
    jax_frames.write_frames_csv(jpath, frames)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(
        frames_io.read_frames_csv(path, 20, 12, 2), frames)


def test_report_results_matches_jax(tmp_path):
    """The port's decision-log writer writes the JAX writer's bytes."""
    from vvc_affine_tpu.runtime import reporting as jax_reporting

    rng = np.random.default_rng(5)
    for pred, n_cu in ((0, 201), (3, 284)):
        costs = rng.integers(0, 1 << 40, size=(2, n_cu)).astype(np.int64)
        cpmvs = rng.integers(-5000, 5000, size=(2, n_cu, 3, 2)).astype(
            np.int32)
        for poc, ref in ((1, 0), (2, 1)):
            jax_reporting.report_results(str(tmp_path / "j"), pred, 200,
                                         costs, cpmvs, poc, ref)
            reporting.report_results(str(tmp_path / "t"), pred, 200,
                                     costs, cpmvs, poc, ref)
        for jp, tp in zip(jax_reporting.log_paths(str(tmp_path / "j"), pred),
                          reporting.log_paths(str(tmp_path / "t"), pred)):
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read(), tp


def test_cli_refuses_unported_flags(monkeypatch, capsys):
    """Every flag of the JAX CLI is ported; a split over more cards than
    the machine has exits with code 1 (as the JAX CLI does) before it
    reads a frame or joins a process group, and the mesh never shrinks."""
    base = ["-f", "1", "-s", "128x128", "-q", "32", "-o", "x", "-r", "y"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for extra, need in ((["--NumChips", "3"], "3 devices starting at "
                         "index 0, have 2"),
                        (["--NumChips", "2", "--DeviceIndex", "1"],
                         "2 devices starting at index 1, have 2"),
                        (["--Coordinator", "127.0.0.1:1", "--NumProcesses",
                          "2", "--ProcessId", "1", "--DeviceIndex", "2"],
                         "1 devices starting at index 2, have 2")):
        assert torch_cli.main(base + extra) == 1
        assert f"Need {need}" in capsys.readouterr().err
    args = torch_cli.build_parser().parse_args(
        base + ["--NumChips", "2", "--Coordinator", "h:1", "--NumProcesses",
                "4", "--ProcessId", "3", "--CheckpointDir", "c",
                "--DeviceTrace", "t.csv", "--MemoryReport", "--Engine",
                "gather"])
    assert (args.NumChips, args.Coordinator, args.NumProcesses,
            args.ProcessId) == (2, "h:1", 4, 3)


@pytest.mark.parametrize("index", [1, -1])
def test_cli_device_index_out_of_range(monkeypatch, capsys, index):
    """``--DeviceIndex`` past the cards (or negative) prints the JAX CLI's
    message and exits with code 1 before it reads a frame."""
    base = ["-f", "1", "-s", "128x128", "-q", "32", "-o", "x", "-r", "y"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_cli.main(base + ["--DeviceIndex", str(index)]) == 1
    assert (f"DeviceIndex {index} out of range (1 devices)"
            in capsys.readouterr().err)


def test_checkpoint_clear_matches_jax(tmp_path):
    """``clear()`` drops the marker (a cleared marker reads 0, and a second
    clear is harmless), as the JAX package's; a follower's clear changes
    nothing, as there."""
    from vvc_affine_tpu.runtime import checkpoint as jax_checkpoint

    from vvc_affine_tpu_torch.runtime.checkpoint import FollowerCheckpoint

    for manager in (CheckpointManager, jax_checkpoint.CheckpointManager):
        ckpt = manager(str(tmp_path / manager.__module__), None)
        ckpt.mark_frame_done(3)
        assert ckpt.completed_poc() == 3
        ckpt.clear()
        assert ckpt.completed_poc() == 0
        ckpt.clear()
    for follower in (FollowerCheckpoint, jax_checkpoint.FollowerCheckpoint):
        f = follower(2)
        f.clear()
        assert f.completed_poc() == 2


def _poc_rows(logs):
    """POC column of every row of every log (headers skipped)."""
    return sorted({int(ln.split(b",", 1)[0]) for data in logs.values()
                   for ln in data.splitlines()[1:]})


def test_cli_resumed_run_matches_jax(tmp_path, jax_run):
    """-f 1, then -f 2 on the same checkpoint: the JAX uninterrupted logs."""
    args, want = jax_run
    ckpt = str(tmp_path / "ckpt")
    run = args + ["-l", str(tmp_path / "torch"), "--CheckpointDir", ckpt]
    assert torch_cli.main(["-f", "1"] + run, device="cpu") == 0
    assert CheckpointManager(ckpt, None).completed_poc() == 1
    assert _poc_rows(_logs(str(tmp_path), "torch")) == [1]
    assert torch_cli.main(["-f", str(N)] + run, device="cpu") == 0
    assert CheckpointManager(ckpt, None).completed_poc() == N
    assert _logs(str(tmp_path), "torch") == want


def test_cli_resume_after_a_crash_matches_jax(tmp_path, jax_run, monkeypatch):
    """A run that dies while POC 2's results are written (after refIdx 0,
    before refIdx 1), then resumed: the partial frame's rows are pruned and
    the logs end as the JAX uninterrupted run's."""
    args, want = jax_run
    ckpt = str(tmp_path / "ckpt")
    run = ["-f", str(N)] + args + ["-l", str(tmp_path / "torch"),
                                   "--CheckpointDir", ckpt]
    real = reporting.report_results

    def dies_in_poc2(prefix, pred, frame_w, costs, cpmvs, poc, ref, **kw):
        if (poc, ref) == (2, 1):
            raise RuntimeError("killed in POC 2")
        real(prefix, pred, frame_w, costs, cpmvs, poc, ref, **kw)

    monkeypatch.setattr(reporting, "report_results", dies_in_poc2)
    with pytest.raises(RuntimeError, match="killed in POC 2"):
        torch_cli.main(run, device="cpu")
    monkeypatch.undo()
    assert CheckpointManager(ckpt, None).completed_poc() == 1
    assert _poc_rows(_logs(str(tmp_path), "torch")) == [1, 2]
    assert torch_cli.main(run, device="cpu") == 0
    assert _logs(str(tmp_path), "torch") == want


def test_prune_logs_after_matches_jax(tmp_path):
    """The port's pruning leaves the JAX pruning's bytes on the same partly
    written logs: whole rows of later POCs, a torn last row, a stray line
    and an empty file."""
    from vvc_affine_tpu.runtime.checkpoint import \
        CheckpointManager as JaxCheckpointManager

    rng = np.random.default_rng(6)
    stems = {"j": JaxCheckpointManager, "t": CheckpointManager}
    for pred, n_cu in ((0, 201), (3, 284)):
        costs = rng.integers(0, 1 << 40, size=(2, n_cu)).astype(np.int64)
        cpmvs = rng.integers(-5000, 5000, size=(2, n_cu, 3, 2)).astype(
            np.int32)
        for stem in stems:
            for poc, ref in ((1, 0), (2, 0), (2, 1), (3, 0)):
                reporting.report_results(str(tmp_path / stem), pred, 200,
                                         costs, cpmvs, poc, ref)
            paths = reporting.log_paths(str(tmp_path / stem), pred)
            with open(paths[0], "a") as f:
                f.write("not,a,row\n3,0,1,2,40")
            open(paths[-1], "w").close()
    for stem, manager in stems.items():
        manager(str(tmp_path / f"ck_{stem}"),
                str(tmp_path / stem)).prune_logs_after(2)
    j, t = _logs(str(tmp_path), "j"), _logs(str(tmp_path), "t")
    assert len(j) == sum(len(reporting.log_paths("x", p)) for p in (0, 3))
    assert t == j
    assert _poc_rows(t) == [1, 2]


def test_device_trace_and_memory_report_on_the_cpu(tmp_path, capsys):
    """--DeviceTrace writes the JAX sampler's header (zeros on the CPU);
    --MemoryReport prints the port's table."""
    from vvc_affine_tpu.runtime import reporting as jax_reporting

    jax_trace = str(tmp_path / "jax.csv")
    sampler = jax_reporting.DeviceTraceSampler(jax_trace)
    sampler.start()
    sampler.stop()
    opath, rpath = _fixture(str(tmp_path), FW, FH, 1)
    trace = str(tmp_path / "torch.csv")
    assert torch_cli.main(["-f", "1", "-s", f"{FW}x{FH}", "-q", "32",
                           "-o", opath, "-r", rpath, "--DeviceTrace", trace,
                           "--MemoryReport"], device="cpu") == 0
    out = capsys.readouterr().out
    with open(jax_trace) as a, open(trace) as b:
        jax_lines, lines = a.read().splitlines(), b.read().splitlines()
    assert lines[0] == jax_lines[0] == "t_epoch,bytes_in_use,peak_bytes_in_use"
    assert len(lines) > 1
    assert all(ln.split(",")[1:] == ["0", "0"] for ln in lines[1:])
    assert f"device trace: {len(lines) - 1} samples -> {trace}" in out
    assert f"MEMORY USAGE (bytes), frame {FW}x{FH}, 1 CTUs" in out
    assert "device bytes_in_use: n/a" in out


def _report_lines(text):
    return dict(ln.rsplit(": ", 1) if ": " in ln else (ln, "")
                for ln in text.splitlines())


def test_memory_report_shared_lines_match_jax():
    """At 1920x1080 every buffer both packages hold has the JAX report's
    line and number; the TPU-only buffers have none."""
    from vvc_affine_tpu.runtime import reporting as jax_reporting

    jax_lines = _report_lines(jax_reporting.memory_report(1920, 1080))
    lines = _report_lines(reporting.memory_report(1920, 1080, "cpu"))
    shared = {k for k in lines if k in jax_lines
              and not k.startswith("device ")}
    for mode in ("full", "half"):
        assert {f"[{mode}] displacement/phase planes dy,dx,fx,fy (int32)",
                f"[{mode}] pred planes (int16)",
                f"[{mode}] per-CU cost/cpmvs out (int64+int32)",
                f"[{mode}] equation systems M,rhs 2CP (int64)",
                f"[{mode}] equation systems M,rhs 3CP (int64)"} <= shared
        assert f"[{mode}] K2 moment blocks (int32)" in lines
    assert {"MEMORY USAGE (bytes), frame 1920x1080, 135 CTUs",
            "ref/orig plane (int32)"} <= shared
    assert {k: lines[k] for k in shared} == {k: jax_lines[k] for k in shared}
    assert not any(k.startswith(("refpad", "per-CTU ref tiles"))
                   or "tap planes" in k for k in lines)
    assert lines["device bytes_in_use"] == "n/a"


@pytest.mark.parametrize("entry", ["read_frames_csv", "stage_inputs",
                                   "pipeline"])
def test_samples_outside_10_bits_are_refused(tmp_path, entry):
    """Every entry point that takes frames refuses a sample above 1023 (the
    warp kernel packs samples as int16 pairs and is exact only for 10-bit
    ones) and takes 1023 itself."""
    from vvc_affine_tpu_torch.models import affine_plane as tap
    from vvc_affine_tpu_torch.models import pipeline

    fw = fh = 128
    good = np.full((1, fh, fw), 1023, np.int32)
    bad = good.copy()
    bad[0, 5, 7] = 1024
    if entry == "read_frames_csv":
        def run(frames):
            path = str(tmp_path / "f.csv")
            frames_io.write_frames_csv(path, frames)
            return frames_io.read_frames_csv(path, fw, fh, 1)
    elif entry == "stage_inputs":
        z = tap.zero_cpmvs(tap.PlaneSpec("full", 2, fw, fh), "cpu")

        def run(frames):
            return tap.stage_inputs_from_numpy(good[0], frames[0], 57.54, z,
                                               "cpu")
    else:
        pipe = pipeline.AffineMEPipeline(pipeline.PipelineConfig(
            fw, fh, 32, test_half=False, device="cpu"))

        def run(frames):
            return pipe.encode(good, frames, on_result=lambda r: None)
    with pytest.raises(ValueError, match="1023"):
        run(bad)
    if entry != "pipeline":            # a whole encode is tested elsewhere
        run(good)


def test_cli_num_chips_matches_jax(tmp_path, jax_run):
    """``--NumChips 2`` on the CPU: the frame's one CTU on one shard, a
    padding CTU on the other; the JAX logs."""
    args, want = jax_run
    assert torch_cli.main(["-f", str(N)] + args
                          + ["-l", str(tmp_path / "n2"), "--NumChips", "2"],
                          device="cpu") == 0
    assert _logs(str(tmp_path), "n2") == want


# a CLI process on the CPU, one intra-op thread (two run at once)
_CLI_CHILD = ("import sys, torch; torch.set_num_threads(1); "
              "from vvc_affine_tpu_torch import cli; "
              "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def _two_processes(argv, tmp):
    """Run the port's CLI as processes 0 and 1 of a gloo group on a free
    local port, process k with ``-l <tmp>/p<k>``; both must exit 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI_CHILD, *argv,
         "-l", os.path.join(tmp, f"p{k}"),
         "--Coordinator", f"127.0.0.1:{port}", "--NumProcesses", "2",
         "--ProcessId", str(k)],
        cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]


def test_cli_two_processes_match_jax(tmp_path, jax_run):
    """Two processes over gloo, one shard each: process 0's logs are the
    JAX logs, and process 1 writes none."""
    args, want = jax_run
    _two_processes(["-f", str(N)] + args, str(tmp_path))
    assert _logs(str(tmp_path), "p0") == want
    assert _logs(str(tmp_path), "p1") == {}


def test_cli_two_processes_resume_matches_jax(tmp_path, jax_run):
    """Two processes, -f 1 and then -f 2 on one checkpoint: process 1 skips
    the frame process 0's marker says is done (``FollowerCheckpoint``),
    and process 0's logs end as the JAX uninterrupted run's."""
    args, want = jax_run
    ckpt = str(tmp_path / "ckpt")
    _two_processes(["-f", "1"] + args + ["--CheckpointDir", ckpt],
                   str(tmp_path))
    assert CheckpointManager(ckpt, None).completed_poc() == 1
    assert _poc_rows(_logs(str(tmp_path), "p0")) == [1]
    _two_processes(["-f", str(N)] + args + ["--CheckpointDir", ckpt],
                   str(tmp_path))
    assert CheckpointManager(ckpt, None).completed_poc() == N
    assert _logs(str(tmp_path), "p0") == want
    assert _logs(str(tmp_path), "p1") == {}
