"""CTU-axis split of a stage over several devices.

Port of the JAX package's ``parallel/mesh.py``, with its contract: a sharded
stage takes and returns the unsharded stage's ``[nCtu, ...]`` tensors and
gives the same outputs, bit for bit.

* The CTU axis is padded to a multiple of the shard count.  The padding
  CTUs sit at (frame_w, frame_h), so every CU in them fails the in-frame
  test (``affine_plane.build_tables`` / ``affine_me.build_tables`` with
  ``n_ctu_pad``); their slabs are inactive, so K1 skips them.
* Shard ``k`` owns the contiguous rows ``[k * per, (k + 1) * per)`` of the
  padded axis.  Every op of a stage acts per CTU, so a shard's result does
  not depend on the other shards' rows.
* The frames are replicated: each is staged once on every distinct device
  (``replicate``).  No collective runs inside a stage.
* The padding is sliced off after the run.

A ``Mesh`` lists this process's devices, one per shard; a list may name one
card more than once, and then its shards run on that card one after
another.  The shards are issued one after another from the calling thread.
On a card, the work of each distinct device (for the plane engine its
prep, then that device's shards; for the gather engine its shards) is one
CUDA graph, captured at the first call and replayed after
(``runtime.graphs``, as ``affine_plane.build_stage`` and
``affine_me.build_stage``); one runner (``_sharded``) serves both engines.
The input checks, the padding of the CPMVs, the join and every collective
stay outside the graphs.  In one process a sharded
stage returns the whole result on the mesh's first device.  In a run of
several processes (``runtime.distributed``) each process runs its own
shards, and a sharded stage returns this process's rows as a
``ProcessBlock``, which ``distributed.gather_to_host`` gathers.  While a
``runtime.tracing`` recorder is active, the input moves (``mesh.inputs``),
each distinct device's issue (``mesh.issue``, attribute ``card``), the
join (``mesh.join``) and ``replicate``'s pin and copy to each card
(``mesh.pin``) are spans.

Not ported, because they are TPU or XLA workarounds: the escape-counter
telemetry and its psums, ahead-of-time compilation (``precompile``) and
``check_vma``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from vvc_affine_tpu_torch import geometry as G
from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_me, affine_plane
from vvc_affine_tpu_torch.runtime import graphs, tracing


@dataclass(frozen=True)
class Mesh:
    """The shards of a CTU split that this process runs.

    ``devices``: one device per local shard; ``n_shards``: shards over all
    processes; ``first``: the global index of ``devices[0]``'s shard (the
    global order is rank-major).
    """

    devices: Tuple[torch.device, ...]
    n_shards: int
    first: int = 0


class ProcessBlock(NamedTuple):
    """This process's rows of a CTU-axis result split over processes: its
    block ``rows`` of the padded axis (every process's block has the same
    length) and the unpadded CTU count ``n_ctus``."""

    rows: torch.Tensor
    n_ctus: int


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A one-process mesh with one shard per entry of ``devices``; by
    default every visible card, ``cuda:0`` to ``cuda:<count-1>`` (raises
    when there is none).  A CPU mesh takes CPU devices, given."""
    if devices is None:
        resolve_device("cuda:0")         # raises when there is no card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, len(devs))


def distinct_devices(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The mesh's devices, each once, in mesh order."""
    return tuple(dict.fromkeys(mesh.devices))


def replicate(x: torch.Tensor, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """``x`` once on every distinct device of the mesh; a host tensor goes
    to a card from pinned memory, asynchronously."""
    out = {}
    for d in distinct_devices(mesh):
        if d.type == "cuda" and x.device.type == "cpu":
            with tracing.span("mesh.pin", card=d):
                out[d] = x.pin_memory().to(d, non_blocking=True)
        else:
            out[d] = x.to(d)
    return out


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


class _Counts(NamedTuple):
    """What ``affine_plane.check_inputs`` reads of a stage's tables."""

    n_ctus: int
    n_cus: int


class _Split:
    """One frame geometry split over a mesh: the padded CTU count, this
    process's rows [lo, hi) of the padded axis, and per local shard its
    device and rows."""

    def __init__(self, spec, mesh: Mesh):
        self.spec = spec
        self.n_ctus = G.frame_grid(spec.frame_w, spec.frame_h).num_ctus
        self.n_cus = G.layout(spec.mode).cus_per_ctu
        self.n_pad = _pad_to(self.n_ctus, mesh.n_shards)
        per = self.n_pad // mesh.n_shards
        self.lo = mesh.first * per
        self.hi = self.lo + len(mesh.devices) * per
        self.devices = distinct_devices(mesh)
        self.shards = [(d, self.lo + k * per, self.lo + (k + 1) * per)
                       for k, d in enumerate(mesh.devices)]
        self.across_processes = mesh.n_shards > len(mesh.devices)

    def inputs(self, ref_flat, orig_flat, lam, prev):
        """Per distinct device: (ref, orig, lam, this process's rows of the
        padded prev), each checked against the stage contract.

        ``ref_flat``, ``orig_flat`` and ``lam`` are tensors or ``replicate``
        results; ``prev`` is the unpadded [nCtu, nCU, 3, 2] tensor or this
        process's ``ProcessBlock`` of an earlier stage on the same mesh.
        """
        block = isinstance(prev, ProcessBlock)
        if block:
            if prev.n_ctus != self.n_ctus:
                raise ValueError(f"prev_cpmvs: a block of {prev.n_ctus} "
                                 f"CTUs, want {self.n_ctus}")
            prev, counts = prev.rows, _Counts(self.hi - self.lo, self.n_cus)
        else:
            counts = _Counts(self.n_ctus, self.n_cus)
        out = {}
        for d in self.devices:
            args = [x[d] if isinstance(x, dict) else x.to(d)
                    for x in (ref_flat, orig_flat, lam, prev)]
            affine_plane.check_inputs(counts, self.spec, d, *args)
            if not block:
                pad = args[3].new_zeros((self.n_pad - self.n_ctus,)
                                        + tuple(args[3].shape[1:]))
                args[3] = torch.cat([args[3], pad])[self.lo:self.hi]
            out[d] = args
        return out

    def local(self, lo: int, hi: int) -> slice:
        """Padded rows [lo, hi) within this process's rows."""
        return slice(lo - self.lo, hi - self.lo)

    def join(self, outs):
        """The shards' outputs (one tuple per shard) joined on the first
        device: unpadded tensors, or across processes ``ProcessBlock``s."""
        first = self.devices[0]
        joined = [torch.cat([o.to(first) for o in parts])
                  for parts in zip(*outs)]
        if self.across_processes:
            return tuple(ProcessBlock(x, self.n_ctus) for x in joined)
        return tuple(x[:self.n_ctus] for x in joined)


def _sharded(spec, mesh: Mesh, engine, core, prep=None):
    """A stage runner over ``mesh`` for either engine (``engine``: the
    ``affine_plane`` or ``affine_me`` module, whose ``build_tables`` and
    ``ctu_rows`` it uses).  Per distinct device: ``prep(spec, tables,
    ref_flat, orig_flat)`` once on that device's padded tables, when given
    (the plane engine's CTU planes), then per shard ``core(t, ref_flat,
    orig_flat, lam, prev, *planes)`` on the shard's rows ``t`` of the
    tables and its rows of ``prev`` and of each prepped plane.  On a card
    the work of each distinct device is one CUDA graph
    (``runtime.graphs``); the input checks, the padding of ``prev``
    (``_Split.inputs``) and the join stay outside it.  ``run.per_device``
    maps each distinct device to its runner (a ``graphs.Graphed`` on a
    card, the eager function on the CPU)."""
    split = _Split(spec, mesh)
    tables = {d: engine.build_tables(spec, device=d, n_ctu_pad=split.n_pad)
              for d in split.devices}

    # per distinct device: its shards' rows of the tables and of the
    # process's padded axis
    shards = {d: [(engine.ctu_rows(tables[d], lo, hi), split.local(lo, hi))
                  for dd, lo, hi in split.shards if dd == d]
              for d in split.devices}

    def on_device(d):
        def run(ref, orig, lam, prev):
            # this process's rows of the padded planes
            pls = () if prep is None else tuple(
                pl[split.lo:split.hi] for pl in prep(spec, tables[d], ref,
                                                     orig))
            # d's shards' outputs, flat
            return tuple(x for t, rows in shards[d] for x in core(
                t, ref, orig, lam, prev[rows], *(pl[rows] for pl in pls)))

        return graphs.for_device(run, d)

    per_device = {d: on_device(d) for d in split.devices}

    def run(ref_flat, orig_flat, lam, prev):
        with tracing.span("mesh.inputs"):
            inputs = split.inputs(ref_flat, orig_flat, lam, prev)
        outs = {}
        for d, fn in per_device.items():
            with tracing.span("mesh.issue", card=d):
                flat = fn(*inputs[d])
            n = len(flat) // len(shards[d])
            outs[d] = iter([flat[k:k + n] for k in range(0, len(flat), n)])
        with tracing.span("mesh.join"):
            return split.join([next(outs[d]) for d, _, _ in split.shards])

    run.per_device = per_device
    return run


def build_plane_pair_sharded(spec2: affine_plane.PlaneSpec,
                             spec3: affine_plane.PlaneSpec, mesh: Mesh):
    """``affine_plane.build_pair_stage`` split over ``mesh``: fn(ref_flat,
    orig_flat, lam, prev2) -> (cost2, cpmvs2, cost3, cpmvs3), the CPMV
    handoff staying on each shard."""
    if not (spec2.mode == spec3.mode and spec2.n_cp == 2
            and spec3.n_cp == 3):
        raise ValueError("build_plane_pair_sharded takes a mode's 2CP and "
                         "3CP specs")

    def core(t, ref, orig, lam, prev2, orig_pl, ref_pl):
        c2, p2 = affine_plane._stage_core(spec2, t, ref, orig_pl, ref_pl,
                                          lam, prev2)
        c3, p3 = affine_plane._stage_core(spec3, t, ref, orig_pl, ref_pl,
                                          lam, p2)
        return c2, p2, c3, p3

    return _sharded(spec2, mesh, affine_plane, core, affine_plane.prep_inputs)


def build_plane_stage_sharded(spec: affine_plane.PlaneSpec, mesh: Mesh):
    """``affine_plane.build_stage`` split over ``mesh``: fn(ref_flat,
    orig_flat, lam, prev_cpmvs) -> (cost, cpmvs)."""
    def core(t, ref, orig, lam, prev, orig_pl, ref_pl):
        return affine_plane._stage_core(spec, t, ref, orig_pl, ref_pl, lam,
                                        prev)

    return _sharded(spec, mesh, affine_plane, core, affine_plane.prep_inputs)


def build_stage_sharded(spec: affine_me.StageSpec, mesh: Mesh):
    """``affine_me.build_stage`` (the gather engine) split over ``mesh``:
    fn(ref_flat, orig_flat, lam, prev_cpmvs) -> (cost, cpmvs)."""
    return _sharded(spec, mesh, affine_me,
                    functools.partial(affine_me._stage_run, spec))
