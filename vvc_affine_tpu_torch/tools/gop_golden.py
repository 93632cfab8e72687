"""The plane engine against the gather engine through the whole CLI, with a
JSON artifact.

Counterpart of the JAX repository's ``tools/gop_golden.py``: the decision
logs are the reference's product (main_aux_functions.h:387-525), so this
drives the port's CLI twice on one synthetic GOP — ``--Engine plane`` (the
hand-written kernels) and then ``--Engine gather`` (plain PyTorch ops, no
kernel), each in its own child process, one after the other — and diffs
every decision-log CSV byte for byte, the two sets of log names first.  4K
(3840x2160, 510 CTUs) is the default:

    python -m vvc_affine_tpu_torch.tools.gop_golden [WxH] [--frames N] \\
        [--out FILE]

The GOP is the one of the JAX repository's ``tests/test_gop_parity.py``:
a uniform 10-bit frame from seed 31 that drifts by (2, -1) samples per
frame with noise in [-12, 12), written with
``runtime.frames.write_frames_csv``.  Each child prints its kernels' launch
counts and ``torch.cuda.max_memory_allocated`` (null on the CPU); the
artifact records them beside the wall seconds and the seconds per frame-ref
of the CLI's timing report (CUDA events, FULL + HALF).  On a card a
process's first frame-ref also warms up and captures the engine's CUDA
graphs (``runtime.graphs``: the plane engine's pairs, the gather engine's
stages), and its later frame-refs replay them, so
the artifact gives the first frame-ref and the later ones apart
(``first_frame_ref_s``, ``later_frame_ref_s``; ``--frames 2`` or more has
later ones).  It goes to ``--out``, else to a new temporary file.  Exit 0 when every log is
byte-identical, 2 when one differs; a failed child raises.
``main(argv, device="cpu")`` runs both children on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.tools import common

ENGINES = ("plane", "gather")

# one CLI run on a device, then its kernel launches and peak device bytes
_CHILD = """
import json, sys
import torch
from vvc_affine_tpu_torch import cli, kernels
device, threads, argv = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
torch.set_num_threads(threads)
kernels.reset_launches()
rc = cli.main(argv, device=device)
if device.startswith("cuda"):
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
else:
    peak = None
print(json.dumps({"gop_child": {"launches": dict(kernels.launches),
                                "max_memory_allocated": peak}}))
sys.exit(rc)
"""


def gop(fw: int, fh: int, n: int):
    """The GOP's original frames (POC 1..n) and reconstructed frames (POC
    0..n-1), uint16 [n, fh, fw] each."""
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
    return (np.stack(origs).astype(np.uint16),
            np.stack(refs[:n]).astype(np.uint16))


def fixture(tmp: str, fw: int, fh: int, n: int):
    """The GOP's original and reference CSVs in ``tmp``."""
    origs, refs = gop(fw, fh, n)
    opath = os.path.join(tmp, "orig.csv")
    rpath = os.path.join(tmp, "ref.csv")
    frames_io.write_frames_csv(opath, origs)
    frames_io.write_frames_csv(rpath, refs)
    return opath, rpath


def frame_ref_s(lines) -> dict:
    """Seconds per frame-ref ("POC p ref r"), FULL and HALF summed, from
    the CLI timing report's "EXEC <pred(s)> POC p ref r,<ns>" lines."""
    out = {}
    for ln in lines:
        if ln.startswith("EXEC ") and "," in ln:
            label, ns = ln.rsplit(",", 1)
            key = label.split(" ", 2)[2]
            out[key] = out.get(key, 0.0) + float(ns) / 1e9
    return out


def run_engine(engine: str, device, argv) -> dict:
    """One child: the CLI with ``--Engine engine``; raises when it
    fails."""
    t0 = time.time()
    child = common.python_child(
        _CHILD, str(device), str(torch.get_num_threads()), *argv,
        "--Engine", engine, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out, _ = child.communicate()
    wall = time.time() - t0
    print(f"{engine}: rc={child.returncode} {wall:.1f}s", flush=True)
    if child.returncode != 0:
        sys.stdout.write(out[-3000:])
        raise subprocess.CalledProcessError(child.returncode,
                                            f"the {engine} CLI child")
    res = json.loads(out.strip().splitlines()[-1])["gop_child"]
    return {"wall_s": wall, "frame_ref_s": frame_ref_s(out.splitlines()),
            **res}


def diff_logs(tmp: str):
    """(verdict, count of plane logs, entry per log name) of the plane_*
    against the gather_* logs in ``tmp``, the sets of names compared
    first; no log at all is a mismatch too."""
    files = {}
    verdict = "byte-identical"
    plane = sorted(f for f in os.listdir(tmp) if f.startswith("plane_"))
    gather = sorted(f for f in os.listdir(tmp) if f.startswith("gather_"))
    psuf = {f[len("plane_"):] for f in plane}
    gsuf = {f[len("gather_"):] for f in gather}
    if psuf != gsuf:
        verdict = "MISMATCH"
        for suf in sorted(psuf ^ gsuf):
            files[suf] = {"match": False,
                          "only_in": "plane" if suf in psuf else "gather"}
    for suf in sorted(psuf & gsuf):
        with open(os.path.join(tmp, "plane_" + suf), "rb") as fa, \
                open(os.path.join(tmp, "gather_" + suf), "rb") as fb:
            da, db = fa.read(), fb.read()
        files[suf] = {"bytes": len(da),
                      "sha256": hashlib.sha256(da).hexdigest()[:16],
                      "match": da == db}
        if da != db:
            verdict = "MISMATCH"
    if not psuf:
        verdict = "MISMATCH"
    return verdict, len(plane), files


def main(argv=None, device=None) -> int:
    """0 when the logs are byte-identical, 2 when not; ``device``
    overrides ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.gop_golden",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    parser.add_argument("resolution", nargs="?", default=(3840, 2160),
                        type=common.frame_size, help="WxH (3840x2160)")
    parser.add_argument("--frames", type=int, default=1,
                        help="frames to encode (-f)")
    parser.add_argument("--out", default="",
                        help="JSON artifact (default: a new temporary file)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    fw, fh = args.resolution
    n = args.frames
    if n < 1:
        parser.error("--frames must be at least 1")
    out_path = args.out or common.temp_path("gop_golden_", ".json")

    with tempfile.TemporaryDirectory(prefix="gop_golden_") as tmp:
        opath, rpath = fixture(tmp, fw, fh, n)
        cli_argv = ["-f", str(n), "-s", f"{fw}x{fh}", "-q", "32",
                    "-o", opath, "-r", rpath]
        runs = {e: run_engine(e, dev, cli_argv
                              + ["-l", os.path.join(tmp, f"{e}_")])
                for e in ENGINES}
        verdict, n_logs, files = diff_logs(tmp)

    artifact = {
        "workload": f"-f {n} -s {fw}x{fh} -q 32, all four pred types",
        "engines": "plane (hand-written kernels) vs gather (plain PyTorch "
                   "ops), the whole CLI, one child process each, in turn",
        "date": time.strftime("%Y-%m-%d"),
        "device": common.card_line(dev),
        "n_log_files": n_logs,
        "verdict": verdict,
        "wall_s": {e: r["wall_s"] for e, r in runs.items()},
        "frame_ref_s": {e: r["frame_ref_s"] for e, r in runs.items()},
        "first_frame_ref_s": {e: list(r["frame_ref_s"].values())[:1]
                              for e, r in runs.items()},
        "later_frame_ref_s": {e: list(r["frame_ref_s"].values())[1:]
                              for e, r in runs.items()},
        "launches": {e: r["launches"] for e, r in runs.items()},
        "max_memory_allocated": {e: r["max_memory_allocated"]
                                 for e, r in runs.items()},
        "files": files,
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{verdict}: {n_logs} log files; artifact -> {out_path}")
    print(json.dumps({"gop_golden": {k: v for k, v in artifact.items()
                                     if k != "files"}}), flush=True)
    return 0 if verdict == "byte-identical" else 2


if __name__ == "__main__":
    sys.exit(main())
