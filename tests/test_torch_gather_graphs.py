"""The gather engine's stages are capturable as CUDA graphs, and the CPU runs
them eagerly.

On a card ``affine_me.build_stage`` and ``parallel.mesh.build_stage_sharded``
capture each stage (for the split: each distinct card's shards) as one
CUDA graph (``runtime/graphs.py``).  The CPU has no graphs, so these tests
hold on the CPU what capture needs, with the guard of
``tests/test_torch_graphs.py`` (it fails on every host sync, every tensor
made from host data and every boolean-mask index):

* one FULL and one HALF 2CP->3CP gather chain at 128x128 (one CTU) under
  the guard, after one unguarded call (on the card, the warm-up fills the
  filter bank's per-device cache before the capture); the outputs equal
  the unguarded call's;
* the same for the sharded gather runner's per-device function, on a
  one-CPU mesh;
* ``build_stage`` on the CPU returns the eager function itself, and the
  sharded builder on a CPU mesh builds no ``Graphed``;
* a CPU mesh that names one device twice gives the unsharded FULL gather
  chain bit for bit at 256x128 (2 CTUs, one per shard): the case where
  one card's graph holds two shards.

Whether capture succeeds, and that replays equal the eager loop bit for
bit, only the card shows (``chip_smoke.py``, phases 11b and 11e).  The
split over 3 CPU shards against the JAX pair is in
``tests/test_torch_stage.py``.
"""

import pytest
import torch

from tests.test_torch_graphs import CaptureGuard
from vvc_affine_tpu_torch import testing
from vvc_affine_tpu_torch.models import affine_me as tme
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.parallel import mesh as tmesh
from vvc_affine_tpu_torch.runtime import graphs

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _args(mode, fw, fh, seed):
    orig, recon = testing.affine_gop(fw, fh, 1, seed=seed)
    return tap.stage_inputs_from_numpy(
        recon[0].ravel(), orig[0].ravel(), 57.54,
        tme.zero_cpmvs(tme.StageSpec(mode, 2, fw, fh), "cpu"), "cpu")


def _chain(s2, s3, args):
    """The 2CP stage, then the 3CP stage on its CPMVs."""
    c2, p2 = s2(*args)
    return (c2, p2, *s3(*args[:3], p2))


def _guarded(fn, args):
    """``fn(*args)`` once unguarded, then under the guard: the ops the
    guard refused and whether both calls gave equal outputs."""
    want = fn(*args)
    with CaptureGuard() as guard:
        got = fn(*args)
    return guard.bad, all(torch.equal(g, w)
                          for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("mode", ["full", "half"])
def test_gather_chain_makes_no_host_sync_or_host_tensor(mode):
    s2, s3 = (tme.build_stage(tme.StageSpec(mode, n, 128, 128), "cpu")
              for n in (2, 3))
    bad, same = _guarded(lambda *a: _chain(s2, s3, a),
                         _args(mode, 128, 128, 7))
    assert bad == [], sorted(set(bad))
    assert same


@pytest.mark.parametrize("mode", ["full", "half"])
def test_sharded_gather_device_runner_is_capturable(mode):
    """The per-device function of a split over a one-CPU mesh, 2CP then
    3CP, under the guard, on the inputs ``_Split.inputs`` gives it."""
    mesh = tmesh.make_mesh(["cpu"])
    s2, s3 = (tmesh.build_stage_sharded(tme.StageSpec(mode, n, 128, 128),
                                        mesh).per_device[CPU]
              for n in (2, 3))
    args = tmesh._Split(tme.StageSpec(mode, 2, 128, 128), mesh).inputs(
        *_args(mode, 128, 128, 9))[CPU]
    bad, same = _guarded(lambda *a: _chain(s2, s3, a), args)
    assert bad == [], sorted(set(bad))
    assert same


def test_cpu_builders_build_no_graph():
    spec = tme.StageSpec("full", 2, 128, 128)
    fn = tme.build_stage(spec, "cpu")
    assert fn is tme.eager_stage_fn(spec, CPU)
    assert not isinstance(fn, graphs.Graphed)
    with pytest.raises(ValueError, match="prev_cpmvs"):
        fn.check(*_args("full", 128, 128, 1)[:3],
                 torch.zeros((1, 1, 3, 2), dtype=torch.int32))
    sharded = tmesh.build_stage_sharded(
        spec, tmesh.make_mesh(["cpu", "cpu"]))
    assert list(sharded.per_device) == [CPU]
    assert not any(isinstance(f, graphs.Graphed)
                   for f in sharded.per_device.values())


def test_two_shards_on_one_device_match_unsharded():
    mode, fw, fh = "full", 256, 128
    args = _args(mode, fw, fh, 11)
    specs = [tme.StageSpec(mode, n, fw, fh) for n in (2, 3)]
    want = _chain(*(tme.build_stage(s, "cpu") for s in specs), args)
    mesh = tmesh.make_mesh(["cpu", "cpu"])
    got = _chain(*(tmesh.build_stage_sharded(s, mesh) for s in specs), args)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
