"""Runs of several processes: ``torch.distributed`` set-up, and the gather of
results to every process.

Port of the JAX package's ``runtime/distributed.py``, with its names and
semantics:

* every process runs the same GOP loop and stages the same frames (read
  from the shared CSV inputs) on its own devices;
* the CTU axis of every stage is split over the global shard list, rank
  after rank (``global_mesh``): each process runs its own shards of
  ``parallel.mesh`` and holds its rows of each result;
* the decision-log readback gathers the results to every process
  (``gather_to_host``) and only process 0 writes the logs, the analogue
  of the reference's single-host readback and report
  (main_aux_functions.h:335-383, 387-525).

The process group uses the gloo backend on CPU tensors, over
``tcp://<coordinator>``, with an explicit timeout.  Every collective here
carries host-side values: the completed POC of a resumed run, and the
per-CU results that the JAX package also gathers to the host before it
writes them.  No collective touches device data, and no collective runs
inside a stage.  NCCL would buy nothing here, and it refuses two ranks on
one card, which is the only way a one-card machine can run this path.

The JAX package's gRPC alignment barriers before every collective
(``_align``) are not ported: they kept XLA's compile skew between
processes out of gloo's rendezvous window, and the port compiles nothing.
``align_processes`` is a barrier with a timeout that names where it
stopped.  On a host whose name does not resolve to a local address, set
``GLOO_SOCKET_IFNAME`` (``lo`` for processes on one host).

Usage (one command per process):

    python -m vvc_affine_tpu_torch.cli ... \\
        --Coordinator host0:9876 --NumProcesses 2 --ProcessId $RANK
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vvc_affine_tpu_torch.parallel import mesh as pmesh

# how long set-up, a collective or a barrier may wait for the other
# processes before it raises
TIMEOUT_S = 600


def initialize(coordinator: str, num_processes: int, process_id: int,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group at ``coordinator`` (host:port; process 0
    listens there).  Raises when it cannot be set up within ``timeout_s``
    (and when this process is in a group already)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def _count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def align_processes(tag: str = "dispatch",
                    timeout_s: float = TIMEOUT_S) -> None:
    """A barrier of every process; a no-op in one process.  Raises, naming
    ``tag`` and the processes that did not arrive, when they do not all
    arrive within ``timeout_s``."""
    if _count() == 1:
        return
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} of process {dist.get_rank()} "
                           f"failed: {e}") from e


def finalize() -> None:
    """Leave the process group once every process has reached this point
    (all processes must call it)."""
    if not dist.is_initialized():
        return
    align_processes("exit")
    dist.destroy_process_group()


def is_primary() -> bool:
    """Process 0 of the group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(devices: Optional[Sequence] = None) -> pmesh.Mesh:
    """The CTU split over every process's shards: this process runs one
    shard on each of ``devices`` (by default every visible card,
    ``parallel.mesh.make_mesh``), and every process passes as many, so the
    global shard order is rank-major."""
    local = pmesh.make_mesh(devices)
    n = len(local.devices)
    return pmesh.Mesh(local.devices, n * _count(),
                      n * (dist.get_rank() if dist.is_initialized() else 0))


def broadcast_scalar(value: int) -> int:
    """Process 0's ``value`` on every process (a collective: all call
    it)."""
    if _count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0)
    return int(t[0])


def gather_to_host(x) -> np.ndarray:
    """The whole value of a stage result on this host, as numpy.

    A tensor is fetched as it is.  A ``parallel.mesh.ProcessBlock`` (each
    process holds its block of the padded CTU axis) is all-gathered, every
    process getting the whole array: only process 0 writes logs, but a
    symmetric gather keeps every process on the same path.  The padding is
    sliced off.  All processes must call it for a block.
    """
    if not isinstance(x, pmesh.ProcessBlock):
        return x.cpu().numpy()
    rows = x.rows.cpu()
    parts = [torch.empty_like(rows) for _ in range(_count())]
    dist.all_gather(parts, rows)
    return torch.cat(parts)[:x.n_ctus].numpy()
