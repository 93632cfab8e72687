"""The port's multi-process runtime (``runtime/distributed.py``) in four real
processes over gloo on the CPU.

Each process joins the group, takes process 0's value from
``broadcast_scalar``, builds its ``global_mesh`` (one shard each, rank-major)
and gathers a 10-row result split the way ``parallel/mesh.py`` splits the
CTU axis: padded to 12 rows, process k holding rows [3k, 3k + 3).  Every
process must get the same 10 rows back (``gather_to_host`` is symmetric,
as in the JAX package), only process 0 is primary, and after ``finalize``
each process is on its own again.  A group that cannot be set up raises.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vvc_affine_tpu_torch.runtime import distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 4

_CHILD = """
import json, sys
import torch
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.runtime import distributed as dist

port, rank, n, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    sys.argv[4]
dist.initialize(f"127.0.0.1:{port}", n, rank)
mesh = dist.global_mesh(["cpu"])
# rows [3k, 3k + 3) of a 10-row result padded to 12; row i holds (i, -i),
# the padding rows -1
padded = torch.arange(12, dtype=torch.int64)
padded = torch.stack([padded, -padded], 1).where(padded[:, None] < 10, -1)
block = pmesh.ProcessBlock(padded[3 * rank:3 * rank + 3].clone(), 10)
res = {"primary": dist.is_primary(),
       "bcast": dist.broadcast_scalar(100 + rank),
       "mesh": [len(mesh.devices), mesh.n_shards, mesh.first],
       "gather": dist.gather_to_host(block).tolist(),
       "local": dist.gather_to_host(torch.full((2,), rank)).tolist()}
dist.align_processes("test")
dist.finalize()
res["after"] = [dist.is_primary(), dist.broadcast_scalar(7)]
with open(out, "w") as f:
    json.dump(res, f)
"""


def test_four_processes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [str(tmp_path / f"r{k}.json") for k in range(N_PROC)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(port), str(k), str(N_PROC),
         outs[k]], cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k in range(N_PROC)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    want = np.stack([np.arange(10), -np.arange(10)], 1).tolist()
    for k, out in enumerate(outs):
        with open(out) as f:
            res = json.load(f)
        assert res["primary"] == (k == 0)
        assert res["bcast"] == 100
        assert res["mesh"] == [1, N_PROC, k]
        assert res["gather"] == want
        assert res["local"] == [k, k]
        assert res["after"] == [True, 7]


def test_initialize_raises_without_a_group(tmp_path):
    """Process 1 of 2 with nobody listening at the coordinator: raises
    within its timeout (no fallback to a one-process run); a process id
    outside the group is refused before anything is tried."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = ("import sys; from vvc_affine_tpu_torch.runtime import "
           "distributed as dist; "
           f"dist.initialize('127.0.0.1:{port}', 2, 1, timeout_s=1)")
    r = subprocess.run([sys.executable, "-c", src], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "timed out" in r.stderr, r.stderr[-2000:]
    with pytest.raises(ValueError, match="process id 2"):
        dist.initialize(f"127.0.0.1:{port}", 2, 2)


def test_default_meshes_take_every_card(monkeypatch):
    """``make_mesh()`` and ``global_mesh()`` without devices: one shard on
    each visible card, ``cuda:0`` to ``cuda:<count-1>``, as the JAX
    package's default to every device (a CPU mesh only when CPU devices
    are given)."""
    from vvc_affine_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = tuple(torch.device("cuda", i) for i in range(3))
    assert pmesh.make_mesh() == pmesh.Mesh(cards, 3, 0)
    assert dist.global_mesh() == pmesh.Mesh(cards, 3, 0)
    assert pmesh.make_mesh(["cpu"] * 2).devices == (torch.device("cpu"),) * 2
