"""One cell on the card: ``b1080_ld4_plane`` for a few seconds through the
benchmark's command, as the driver runs it.  Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from mebench import run


@pytest.mark.card
def test_b1080_ld4_plane_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this cell runs on an NVIDIA H100")
    out = subprocess.run(
        [sys.executable, "mebench/run.py", "--workload", "b1080_ld4_plane",
         "--seed", str(2**31 + 5), "--seconds", "4", "--trace", "0"],
        cwd=os.path.dirname(run.HERE), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert set(res["metrics"]) == {"frame_refs_per_s", "frame_ref_p90_ms",
                                   "joules_per_frame_ref", "setup_s"}
