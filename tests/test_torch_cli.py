"""The PyTorch port's CLI writes the JAX CLI's decision logs byte for byte.

Both CLIs run the default main path (plane engine, fused 2CP->3CP pairs,
FULL and HALF) over a two-frame GOP, which covers the reference-buffer
schedule, lambda(QP, POC), the 2CP->3CP chain and the log writer
(main.cpp:578-1010 end to end).  The JAX CLI runs in a child process on the
CPU (XLA:CPU needs the raised stack rlimit for stage compiles, see
tests/_child.py); the port runs here with ``device="cpu"``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._child import _raise_stack
from vvc_affine_tpu_torch import cli as torch_cli
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.runtime import reporting

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


def test_cli_decision_logs_match_jax(tmp_path):
    tmp = str(tmp_path)
    fw, fh, n = 128, 128, 2
    opath, rpath = _fixture(tmp, fw, fh, n)
    args = ["-f", str(n), "-s", f"{fw}x{fh}", "-q", "32",
            "-o", opath, "-r", rpath]
    env = dict(os.environ, VVC_AFFINE_TPU_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "vvc_affine_tpu.cli", *args,
         "-l", os.path.join(tmp, "jax")],
        env=env, cwd=_REPO, preexec_fn=_raise_stack,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])

    assert torch_cli.main(args + ["-l", os.path.join(tmp, "torch")],
                          device="cpu") == 0

    jax_logs = sorted(f[len("jax_"):] for f in os.listdir(tmp)
                      if f.startswith("jax_"))
    torch_logs = sorted(f[len("torch_"):] for f in os.listdir(tmp)
                        if f.startswith("torch_"))
    n_logs = sum(len(reporting.log_paths("x", pred)) for pred in range(4))
    assert len(jax_logs) == n_logs and torch_logs == jax_logs
    for name in jax_logs:
        with open(os.path.join(tmp, "jax_" + name), "rb") as fa, \
                open(os.path.join(tmp, "torch_" + name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _logs(prefix_dir, stem):
    out = {}
    for f in sorted(os.listdir(prefix_dir)):
        if f.startswith(stem + "_"):
            with open(os.path.join(prefix_dir, f), "rb") as fh:
                out[f[len(stem) + 1:]] = fh.read()
    return out


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


def test_cli_refuses_unported_flags(tmp_path, capsys):
    base = ["-f", "1", "-s", "128x128", "-q", "32", "-o", "x", "-r", "y"]
    for extra in (["--NumChips", "2"], ["--Coordinator", "h:1"],
                  ["--CheckpointDir", str(tmp_path)],
                  ["--DeviceTrace", "t.csv"], ["--MemoryReport"],
                  ["--Engine", "gather"]):
        assert torch_cli.main(base + extra, device="cpu") == 1
        assert "not yet ported (ROADMAP)" in capsys.readouterr().err
