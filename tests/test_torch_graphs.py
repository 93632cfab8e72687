"""The plane stage is capturable as one CUDA graph, and the CPU runs it eagerly.

A CUDA graph (``vvc_affine_tpu_torch/runtime/graphs.py``) captures device
work only: an op that copies host data to the card (indexing with a Python
list, ``torch.tensor`` of host values) or waits for the card (``.item()``,
``nonzero``, a boolean mask) breaks the capture.  The CPU has no graphs,
so these tests hold on the CPU what capture needs:

* the slot tables that replaced the stage's list indices
  (``planes.subgrid_index``, the ``sym`` positions of the equation terms)
  give the JAX package's ``spread_cu_to_slots`` / ``reduce_slots_to_cu``
  and equation entries exactly, for every class of both modes;
* one FULL and one HALF pair at one CTU runs under a ``TorchDispatchMode``
  that fails on every host sync and every tensor made from host data, the
  kernels' plain versions excepted (on the card those are the ctypes
  launches, which make no such op); the guard is first shown to catch a
  seeded ``.item()`` and a seeded list index;
* ``build_stage`` and ``build_pair_stage`` on the CPU return the eager
  functions themselves, and ``runtime.graphs`` refuses the CPU;
* the launch counts of a capture go to its record, and each replay adds
  them (``kernels.recording`` / ``add_launches``).

Whether capture succeeds, and that replays equal the eager loop bit for
bit, only the card shows (``chip_smoke.py``, phase 6b).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from vvc_affine_tpu import planes as jplanes
from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch import planes as P
from vvc_affine_tpu_torch import testing
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import blockreduce as tbr
from vvc_affine_tpu_torch.ops import warp as twarp
from vvc_affine_tpu_torch.parallel import mesh as tmesh
from vvc_affine_tpu_torch.runtime import graphs

torch.set_num_threads(1)

CLASSES = [(m, ci) for m in ("full", "half")
           for ci in range(len(P.plane_layout(m)))]


@functools.lru_cache(maxsize=None)
def _tables(mode):
    return tap.build_tables(tap.PlaneSpec(mode, 2, 128, 128), "cpu")


@pytest.mark.parametrize("mode,ci", CLASSES)
def test_slot_tables_match_jax(mode, ci):
    """The device tables' spread, fold and equation-term selection of one
    class against the JAX package's, on seeded per-CU and per-slot values
    (its fold, which slices, sums and stacks only, run on numpy)."""
    t = _tables(mode)
    cp, ct = t.cls[ci], t.cls_t[ci]
    jcp = jplanes.plane_layout(mode)[ci]
    rng = np.random.default_rng(100 * len(mode) + ci)
    vals = rng.integers(-2**20, 2**20, size=(2, 3, cp.num_cus)).astype(
        np.int32)
    got = P.spread_cu_to_slots(torch.from_numpy(vals), cp, ct.cu_index)
    want = np.asarray(jplanes.spread_cu_to_slots(jnp, jnp.asarray(vals),
                                                 jcp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    plane = rng.integers(-2**40, 2**40, size=(2, 3, P.NB, P.NB))
    got = P.reduce_slots_to_cu(torch.from_numpy(plane), cp)
    want = jplanes.reduce_slots_to_cu(np, plane, jcp)
    np.testing.assert_array_equal(got.numpy(), want)

    for n_cp in (2, 3):
        # the JAX engine's selection (models/affine_plane.py,
        # _assemble_equations): entry (p, q) and (q, p) take the reduced
        # term of (min, max) in its p <= q order
        pn = 2 * n_cp
        order = [(p, q) for p in range(pn) for q in range(p, pn)]
        red = rng.integers(-2**40, 2**40, size=(2, cp.num_cus, len(order)))
        cell = {}
        for k, (p, q) in enumerate(order):
            cell[(p, q)] = cell[(q, p)] = red[..., k]
        want = np.stack([np.stack([cell[(p, q)] for q in range(pn)], -1)
                         for p in range(pn)], -2)
        got = torch.from_numpy(red).index_select(
            -1, ct.sym[n_cp]).unflatten(-1, (pn, pn))
        np.testing.assert_array_equal(got.numpy(), want)


# ops that wait for the device or move host data to it
_SYNCS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
          "aten::equal", "aten::masked_select", "aten::item"}
_HOST_DATA = {"aten::lift_fresh", "aten::lift_fresh_copy", "aten::lift"}


class CaptureGuard(TorchDispatchMode):
    """Records every op that a CUDA graph's capture could not take: host
    syncs, tensors made from host data, and indexing with a boolean mask
    (a ``nonzero`` on the card).  Ops inside ``paused()`` are not
    checked."""

    def __init__(self):
        super().__init__()
        self.bad = []
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._paused:
            name = func._schema.name
            if name in _SYNCS or name in _HOST_DATA:
                self.bad.append(name)
            elif name in ("aten::index", "aten::index_put",
                          "aten::index_put_", "aten::_index_put_impl_"):
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in args[1]):
                    self.bad.append(f"{name} with a boolean mask")
        return func(*args, **kwargs)


def test_guard_catches_item_and_list_index():
    x = torch.arange(12).reshape(3, 4)
    for fn, want in ((lambda: x.sum().item(), "aten::_local_scalar_dense"),
                     (lambda: x[..., [0, 2]], "aten::lift_fresh"),
                     (lambda: x[x > 3], "aten::index with a boolean mask"),
                     (lambda: torch.tensor([1, 2]), "aten::lift_fresh")):
        with CaptureGuard() as g:
            fn()
        assert want in g.bad, (want, g.bad)
    # what the stage does instead passes
    idx = torch.tensor([0, 2])
    with CaptureGuard() as g:
        x.index_select(-1, idx)
        torch.where(x > 3, x, 0)
        torch.full((2,), 7)
    assert g.bad == []


@pytest.mark.parametrize("mode", ["full", "half"])
def test_pair_makes_no_host_sync_or_host_tensor(mode, monkeypatch):
    """One pair at 128x128 (one CTU) under the guard, with K1's and K2's
    plain versions unchecked (on the card they are kernel launches); the
    outputs equal the unguarded run's."""
    s2, s3 = (tap.PlaneSpec(mode, n, 128, 128) for n in (2, 3))
    orig, recon = testing.affine_gop(128, 128, 1, seed=7)
    args = tap.stage_inputs_from_numpy(
        recon[0].ravel(), orig[0].ravel(), 57.54, tap.zero_cpmvs(s2, "cpu"),
        "cpu")
    fn = tap.build_pair_stage(s2, s3, "cpu")
    want = fn(*args)
    guard = CaptureGuard()
    for mod, name in ((twarp, "warp"), (tbr, "reduce_blocks")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _f=plain: _paused(guard, _f, a))
    with guard:
        got = fn(*args)
    assert guard.bad == [], sorted(set(guard.bad))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def _paused(guard, fn, args):
    with guard.paused():
        return fn(*args)


def test_cpu_builders_return_the_eager_functions():
    cpu = torch.device("cpu")
    s2, s3 = (tap.PlaneSpec("full", n, 128, 128) for n in (2, 3))
    assert tap.build_pair_stage(s2, s3, "cpu") is tap.eager_pair_fn(s2, s3,
                                                                    cpu)
    for s in (s2, s3):
        assert tap.build_stage(s, "cpu") is tap.eager_stage_fn(s, cpu)
    fn = tap.eager_stage_fn(s2, cpu)
    assert graphs.for_device(fn, cpu) is fn
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.Graphed(fn, cpu)
    # the eager pair is the 2CP stage, then the 3CP stage on its CPMVs
    orig, recon = testing.affine_gop(128, 128, 1, seed=8)
    args = tap.stage_inputs_from_numpy(
        recon[0].ravel(), orig[0].ravel(), 57.54, tap.zero_cpmvs(s2, "cpu"),
        "cpu")
    c2, p2, c3, p3 = tap.build_pair_stage(s2, s3, "cpu")(*args)
    for g, w in zip((c2, p2), tap.build_stage(s2, "cpu")(*args)):
        assert torch.equal(g, w)
    for g, w in zip((c3, p3), tap.build_stage(s3, "cpu")(*args[:3], p2)):
        assert torch.equal(g, w)
    # a sharded pair on CPU shards runs its eager per-device work
    got = tmesh.build_plane_pair_sharded(
        s2, s3, tmesh.make_mesh(["cpu", "cpu"]))(*args)
    for g, w in zip(got, (c2, p2, c3, p3), strict=True):
        assert torch.equal(g, w)


def test_capture_records_launches_and_replays_add_them(monkeypatch):
    """``bind``'s launcher counts in ``kernels.launches``, except inside
    ``recording()``, where the launches go to the record (a capture
    executes nothing); ``add_launches`` adds a record per replay."""
    monkeypatch.setattr(kernels, "_function", lambda name: lambda *a: 0)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "launches",
                        dict.fromkeys(kernels.launches, 0))
    warp = kernels.bind("warp", torch.device("cpu"), 1)
    reduce = kernels.bind("blockreduce", torch.device("cpu"), 1)
    warp()
    with kernels.recording() as record:
        warp()
        reduce()
        reduce()
        with kernels.recording() as inner:
            warp()
        warp()
    assert record == {"warp": 2, "blockreduce": 2} and inner == {"warp": 1}
    assert kernels.launches["warp"] == 1
    assert kernels.launches["blockreduce"] == 0
    for _ in range(3):
        kernels.add_launches(record)
    assert kernels.launches["warp"] == 7
    assert kernels.launches["blockreduce"] == 6
    warp()
    assert kernels.launches["warp"] == 8
