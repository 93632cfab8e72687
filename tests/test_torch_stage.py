"""The port's 2CP->3CP pair stage equals the JAX engine's, bit for bit.

For each alignment mode, ``build_pair_stage`` of the port (plain versions on
the CPU) against the JAX ``build_pair_stage`` on its exact XLA path, at a
2-CTU frame with affine-true content and at the partial-CTU frame 200x136
(the right and bottom CTUs hold out-of-frame CUs, which take the masked
path).  The JAX stages compile in fresh child processes with the raised
stack rlimit (XLA:CPU segfaults compiling stage graphs late in long
processes, see tests/test_plane_engine.py); the four children run at once.
The port's gather engine (``models/affine_me``, 2CP then 3CP) is held
against the same JAX pair outputs: the JAX package's own tests hold its two
engines bit-identical (tests/test_engine_parity.py), so no JAX gather stage
is compiled here.  Also: the port's ``build_tables`` equals the JAX one
field by field, its padded tables equal the JAX package's
``parallel/mesh._padded_dyn_tables``, and the port's CTU-axis split
(``parallel/mesh.py``) over 2 and 3 CPU shards gives the JAX pair outputs
for the plane pair, the separate plane stages and the gather stages (at
256x128, 2 CTUs, the third of 3 shards holds only padding).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._child import _raise_stack
from vvc_affine_tpu.models import affine_plane as jap
from vvc_affine_tpu.parallel import mesh as jmesh
from vvc_affine_tpu_torch import planes as tplanes
from vvc_affine_tpu_torch import testing
from vvc_affine_tpu_torch.models import affine_me as tme
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import blockreduce as tbr
from vvc_affine_tpu_torch.parallel import mesh as tmesh

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((256, 128), (200, 136))
CASES = [(m, w, h) for m in ("full", "half") for w, h in SIZES]
LAM = 57.54

_CHILD_SRC = """
import sys
import numpy as np
import jax.numpy as jnp
from vvc_affine_tpu.models import affine_plane as ap

mode, fw, fh, inp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    sys.argv[4], sys.argv[5]
d = np.load(inp)
s2 = ap.PlaneSpec(mode, 2, fw, fh, use_pallas=False)
s3 = ap.PlaneSpec(mode, 3, fw, fh, use_pallas=False)
res = ap.build_pair_stage(s2, s3)(
    jnp.asarray(d["ref"]), jnp.asarray(d["orig"]), jnp.float32(d["lam"]),
    ap.zero_cpmvs(s2))
np.savez(out, *[np.asarray(r) for r in res])
"""


def _frames(fw, fh):
    """Affine-true content at the 2-CTU size, iid noise at the partial one."""
    if (fw, fh) == SIZES[0]:
        orig, recon = testing.affine_gop(fw, fh, 1, seed=11)
        return recon[0].astype(np.int32).ravel(), orig[0].astype(
            np.int32).ravel()
    rng = np.random.default_rng(fw * fh)
    return (rng.integers(0, 1024, fh * fw).astype(np.int32),
            rng.integers(0, 1024, fh * fw).astype(np.int32))


@pytest.fixture(scope="module")
def jax_pairs(tmp_path_factory):
    """JAX pair-stage outputs for every case, from concurrent children."""
    tmp = tmp_path_factory.mktemp("jax_pairs")
    env = dict(os.environ, VVC_AFFINE_TPU_PLATFORM="cpu")
    procs = {}
    for mode, fw, fh in CASES:
        ref, orig = _frames(fw, fh)
        inp = str(tmp / f"in_{mode}_{fw}.npz")
        out = str(tmp / f"out_{mode}_{fw}.npz")
        np.savez(inp, ref=ref, orig=orig, lam=np.float32(LAM))
        procs[(mode, fw, fh)] = (out, subprocess.Popen(
            [sys.executable, "-c", _CHILD_SRC, mode, str(fw), str(fh), inp,
             out], env=env, cwd=_REPO, preexec_fn=_raise_stack,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = {}
    for key, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=1200)
        assert p.returncode == 0, (key, stdout[-800:], stderr[-2000:])
        with np.load(out) as z:
            results[key] = [z[f"arr_{i}"] for i in range(4)]
    return results


@pytest.mark.parametrize("mode,fw,fh", CASES)
def test_pair_stage_matches_jax(jax_pairs, mode, fw, fh):
    want = jax_pairs[(mode, fw, fh)]
    s2 = tap.PlaneSpec(mode, 2, fw, fh)
    s3 = tap.PlaneSpec(mode, 3, fw, fh)
    ref, orig = _frames(fw, fh)
    z = tap.zero_cpmvs(s2, "cpu")
    args = tap.stage_inputs_from_numpy(ref, orig, LAM, z, "cpu")
    assert args[2].dtype == torch.float32 and args[2].dim() == 0
    got = tap.build_pair_stage(s2, s3, device="cpu")(*args)
    for g, w, dtype in zip(got, want, (torch.int64, torch.int32) * 2):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the per-pred dispatch (two separate stages) gives the same outputs
    c2, p2 = tap.build_stage(s2, device="cpu")(*args)
    c3, p3 = tap.build_stage(s3, device="cpu")(*args[:3], p2)
    for g, w in zip((c2, p2, c3, p3), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode,fw,fh", CASES)
def test_gather_pair_matches_jax(jax_pairs, mode, fw, fh):
    """The gather engine's 2CP stage, then its 3CP stage on the 2CP CPMVs
    (as the pipeline chains them), equals the JAX pair."""
    want = jax_pairs[(mode, fw, fh)]
    ref, orig = _frames(fw, fh)
    z = tme.zero_cpmvs(tme.StageSpec(mode, 2, fw, fh), "cpu")
    args = tap.stage_inputs_from_numpy(ref, orig, LAM, z, "cpu")
    c2, p2 = tme.build_stage(tme.StageSpec(mode, 2, fw, fh), "cpu")(*args)
    c3, p3 = tme.build_stage(tme.StageSpec(mode, 3, fw, fh), "cpu")(
        *args[:3], p2)
    for g, w, dtype in zip((c2, p2, c3, p3), want,
                           (torch.int64, torch.int32) * 2):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode,fw,fh", CASES)
def test_build_tables_match_jax(mode, fw, fh):
    jt = jap.build_tables(jap.PlaneSpec(mode, 2, fw, fh))
    tt = tap.build_tables(tap.PlaneSpec(mode, 2, fw, fh), "cpu")
    assert tap.tables_from_numpy(jt._asdict(), "cpu")._asdict().keys() \
        == tt._asdict().keys()
    shared = [f for f in tap.PlaneTables._fields if f in jt._fields]
    # all but the port's own cls_t, repl (K2's replication flags),
    # mv_slots (the motion-plane kernel's block table) and fold_lanes (the
    # CU fold's lane table)
    assert len(shared) == len(tap.PlaneTables._fields) - 4
    np.testing.assert_array_equal(
        tt.repl.numpy(),
        tbr.replication_flags(torch.from_numpy(jt.border_packed)).numpy())
    np.testing.assert_array_equal(tt.mv_slots.numpy(),
                                  tplanes.bin_slot_table(mode))
    np.testing.assert_array_equal(tt.fold_lanes.numpy(),
                                  tplanes.fold_lane_table(mode))
    for f in shared:
        a, b = getattr(tt, f), getattr(jt, f)
        if isinstance(a, torch.Tensor):
            assert a.numpy().dtype == b.dtype, f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
        elif f == "cls":
            for x, y in zip(a, b, strict=True):
                assert [vars(g) for g in x.subgrids] == \
                    [vars(g) for g in y.subgrids]
                for k in ("class_id", "width", "height", "num_cus",
                          "slot_valid", "slot_cx", "slot_cy", "row_top",
                          "row_bot", "col_left", "col_right"):
                    np.testing.assert_array_equal(getattr(x, k),
                                                  getattr(y, k))
        elif f == "bin_of":
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f
    # the JAX tables rebuilt on a device are the port's own
    t2 = tap.tables_from_numpy(jt._asdict(), "cpu")
    for f in shared:
        a, b = getattr(tt, f), getattr(t2, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.dtype == b.dtype, f


@pytest.mark.parametrize("mode", ["full", "half"])
def test_replication_flags_are_a_host_table(mode, monkeypatch):
    """K2's flags are built with the other tables on the host
    (``_tables_numpy``) and moved to the device as they are: building the
    tables derives nothing on the device."""
    spec = tap.PlaneSpec(mode, 2, 200, 136)
    d = tap._tables_numpy(spec)
    assert isinstance(d["repl"], np.ndarray) and d["repl"].dtype == np.uint8
    np.testing.assert_array_equal(d["repl"], tbr.replication_flags(
        torch.from_numpy(d["border_packed"])).numpy())
    assert d["repl"].any()

    def refuse(_):
        raise AssertionError("flags derived while tables were built")

    monkeypatch.setattr(tbr, "replication_flags", refuse)
    marked = {**d, "repl": d["repl"] ^ 16}
    t = tap.tables_from_numpy(marked, "cpu")
    assert t.repl.dtype == torch.uint8
    np.testing.assert_array_equal(t.repl.numpy(), marked["repl"])


@pytest.mark.parametrize("mode,fw,fh", CASES)
def test_padded_tables_match_jax(mode, fw, fh):
    """The port's tables padded by two CTUs equal the JAX package's padded
    tables (``parallel/mesh._padded_dyn_tables``, numpy only); the padding
    CTUs have no in-frame CU and no active slab, and ``ctu_rows`` takes
    rows of the per-CTU fields and shares the rest."""
    jt = jap.build_tables(jap.PlaneSpec(mode, 2, fw, fh))
    n_pad = jt.n_ctus + 2
    want = jmesh._padded_dyn_tables(jap.PlaneSpec(mode, 2, fw, fh), jt,
                                    n_pad)
    t = tap.build_tables(tap.PlaneSpec(mode, 2, fw, fh), "cpu", n_pad)
    assert t.n_ctus == n_pad
    for f, jf in (("abs_x", "abs_x"), ("abs_y", "abs_y"),
                  ("within", "within"), ("ctu_x", "ctu_x"),
                  ("ctu_y", "ctu_y"), ("slab_active", "slab_act")):
        w = np.asarray(getattr(want, jf))
        assert getattr(t, f).numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(getattr(t, f).numpy(), w, err_msg=f)
    assert not t.within[jt.n_ctus:].any()
    assert not t.slab_active[jt.n_ctus:].any()
    rows = tap.ctu_rows(t, 1, 3)
    assert rows.n_ctus == 2 and torch.equal(rows.ctu_x, t.ctu_x[1:3])
    assert rows.border_packed is t.border_packed and rows.cls_t is t.cls_t


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("mode", ["full", "half"])
def test_sharded_pair_matches_jax(jax_pairs, mode, n_shards):
    """The plane pair split over ``n_shards`` CPU shards equals the JAX
    (unsharded) pair."""
    fw, fh = SIZES[0]
    want = jax_pairs[(mode, fw, fh)]
    s2 = tap.PlaneSpec(mode, 2, fw, fh)
    s3 = tap.PlaneSpec(mode, 3, fw, fh)
    ref, orig = _frames(fw, fh)
    args = tap.stage_inputs_from_numpy(ref, orig, LAM,
                                       tap.zero_cpmvs(s2, "cpu"), "cpu")
    mesh = tmesh.make_mesh(["cpu"] * n_shards)
    got = tmesh.build_plane_pair_sharded(s2, s3, mesh)(*args)
    for g, w, dtype in zip(got, want, (torch.int64, torch.int32) * 2):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("engine", ["plane", "gather"])
def test_sharded_stages_match_jax(jax_pairs, engine):
    """The separate 2CP and 3CP stages split over 3 CPU shards (the last
    holds only padding), 3CP on the 2CP CPMVs: the plane engine's
    (``fused=False``) and the gather engine's equal the JAX pair."""
    fw, fh = SIZES[0]
    want = jax_pairs[("full", fw, fh)]
    ref, orig = _frames(fw, fh)
    z = tap.zero_cpmvs(tap.PlaneSpec("full", 2, fw, fh), "cpu")
    args = tap.stage_inputs_from_numpy(ref, orig, LAM, z, "cpu")
    mesh = tmesh.make_mesh(["cpu"] * 3)
    if engine == "plane":
        s2, s3 = (tmesh.build_plane_stage_sharded(
            tap.PlaneSpec("full", n, fw, fh), mesh) for n in (2, 3))
    else:
        s2, s3 = (tmesh.build_stage_sharded(
            tme.StageSpec("full", n, fw, fh), mesh) for n in (2, 3))
    c2, p2 = s2(*args)
    c3, p3 = s3(*args[:3], p2)
    for g, w, dtype in zip((c2, p2, c3, p3), want,
                           (torch.int64, torch.int32) * 2):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), w)
