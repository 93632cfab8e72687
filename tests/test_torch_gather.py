"""The port's gather engine and its ops equal the JAX package's, exactly.

``ops/{interp,gradient,equations,prof}.py`` of the port against the JAX
functions, run eagerly on the CPU, on inputs made with numpy from a seed:
windows at and past each frame edge with all 16x16 phase pairs, the
14-bit (``last=False``) filter, extreme gradients for the int64 moments,
and the factors of every CU shape of both layouts.  ``models/affine_me``'s
tables against the JAX ``build_tables`` field by field, and its stage with
``extra_iters`` against the port's plane stage.  The whole 2CP->3CP chain
against the JAX engine is in tests/test_torch_stage.py, the CLI in
tests/test_torch_cli.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vvc_affine_tpu import geometry as jgeom
from vvc_affine_tpu.models import affine_me as jme
from vvc_affine_tpu.ops import equations as jeq
from vvc_affine_tpu.ops import gradient as jgrad
from vvc_affine_tpu.ops import interp as jinterp
from vvc_affine_tpu.ops import prof as jprof
from vvc_affine_tpu_torch import testing
from vvc_affine_tpu_torch.models import affine_me as tme
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import equations as teq
from vvc_affine_tpu_torch.ops import gradient as tgrad
from vvc_affine_tpu_torch.ops import interp as tinterp
from vvc_affine_tpu_torch.ops import prof as tprof

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(23)
FW, FH = 40, 24      # a small frame: every window below reaches an edge


def _eq(got, want):
    """Torch ``got`` equals JAX/numpy ``want`` exactly, dtype included."""
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_blocks():
    """Sub-block corners at and next to each frame edge, integer motion
    that keeps each window in the frame or pulls it up to 20 samples past
    an edge, and all 256 (x_frac, y_frac) pairs: bx/by [N, 1], mvx/mvy
    [N, 256] int32."""
    xs = [0, 4, FW // 2, FW - 8, FW - 4]
    ys = [0, 4, FH - 8, FH - 4]
    shift = [-20, -2, 0, 2, 20]
    bx, by, mx, my = (a.reshape(-1, 1).astype(np.int32) for a in np.meshgrid(
        xs, ys, shift, shift, indexing="ij"))
    ph = np.arange(256, dtype=np.int32)
    return bx, by, mx * 16 + ph % 16, my * 16 + ph // 16


def _windows():
    """int32 [256, 11, 11] windows, all 10-bit extremes among them, with
    phase pairs covering all 16x16."""
    win = RNG.integers(0, 1024, (256, 11, 11)).astype(np.int32)
    win[:3] = 1023
    win[3:6, ::2, 1::2] = 0
    win[6:9] = 0
    ph = np.arange(256, dtype=np.int32)
    return win, ph % 16, ph // 16


def test_predict_subblocks_at_and_past_every_frame_edge():
    ref = RNG.integers(0, 1024, FH * FW).astype(np.int32)
    bx, by, mvx, mvy = _edge_blocks()
    got = tinterp.predict_subblocks(_t(ref), FW, FH, _t(bx), _t(by),
                                    _t(mvx), _t(mvy))
    _eq(got, jinterp.predict_subblocks(jnp.asarray(ref), FW, FH,
                                       jnp.asarray(bx), jnp.asarray(by),
                                       jnp.asarray(mvx), jnp.asarray(mvy)))
    win = tinterp.gather_windows(_t(ref), FW, FH, _t(bx), _t(by),
                                 _t(mvx >> 4), _t(mvy >> 4))
    _eq(win, jinterp.gather_windows(jnp.asarray(ref), FW, FH,
                                    jnp.asarray(bx), jnp.asarray(by),
                                    jnp.asarray(mvx >> 4),
                                    jnp.asarray(mvy >> 4)))
    _eq(tinterp.gather_blocks(_t(ref), FW, FH, _t(bx + (mvx >> 4)),
                              _t(by + (mvy >> 4))),
        jinterp.gather_blocks(jnp.asarray(ref), FW, FH,
                              jnp.asarray(bx + (mvx >> 4)),
                              jnp.asarray(by + (mvy >> 4))))


@pytest.mark.parametrize("last", [True, False])
def test_filter_windows_all_phase_pairs(last):
    win, xf, yf = _windows()
    _eq(tinterp.filter_windows(_t(win), _t(xf), _t(yf), last),
        jinterp.filter_windows(jnp.asarray(win), jnp.asarray(xf),
                               jnp.asarray(yf), last))


@pytest.mark.parametrize("h,w", [(16, 16), (16, 64), (32, 8), (128, 128)])
def test_sobel_cu(h, w):
    pred = RNG.integers(0, 1024, (3, h, w)).astype(np.int32)
    pred[0] = 1023 * (np.indices((h, w)).sum(0) % 2)     # extreme gradients
    got = tgrad.sobel_cu(_t(pred))
    want = jgrad.sobel_cu(jnp.asarray(pred))
    for g, w_ in zip(got, want):
        _eq(g, w_)


def _cu_shapes():
    """(sb_rows, sb_cols) of every compute group of both layouts."""
    return sorted({(g.sb_rows, g.sb_cols) for mode in ("full", "half")
                   for g in jgeom.layout(mode).compute_classes})


@pytest.mark.parametrize("n_cp", [2, 3])
def test_subblock_factors_every_cu_shape(n_cp):
    shapes = _cu_shapes()
    assert len(shapes) >= 12
    for sh, sw in shapes:
        got = teq.subblock_factors(sh, sw, n_cp)
        want = jeq.subblock_factors(sh, sw, n_cp)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_cp", [2, 3])
def test_moments_and_system_extreme_gradients(n_cp):
    """int32 gradients up to 2^27: each product needs int64 before the
    sum, and the system's terms reach 2^60 (the JAX int64 arithmetic)."""
    lim = 1 << 27
    gx, gy, err = RNG.integers(-lim, lim, (3, 4, 32, 16)).astype(np.int32)
    gx[0], gy[0], err[0] = lim - 1, -lim, lim - 1
    got = teq.gradient_moments(_t(gx), _t(gy), _t(err))
    want = jeq.gradient_moments(jnp.asarray(gx), jnp.asarray(gy),
                                jnp.asarray(err))
    for g, w in zip(got, want, strict=True):
        _eq(g, w)
    fac = jeq.subblock_factors(8, 4, n_cp)
    M, rhs = teq.assemble_system(*got, teq.factors_to(fac, "cpu"))
    jM, jrhs = jeq.assemble_system(*want, fac)
    _eq(M, jM)
    _eq(rhs, jrhs)


@pytest.mark.parametrize("n_cp", [2, 3])
@pytest.mark.parametrize("w,h", [(16, 16), (64, 32), (128, 8)])
def test_prof_delta_fields(n_cp, w, h):
    cp = RNG.integers(-4000, 4000, size=(64, 3, 2)).astype(np.int32)
    log2w, log2h = int(np.log2(w)), int(np.log2(h))
    got = tprof.prof_delta_fields(_t(cp), log2w, log2h, n_cp)
    want = jprof.prof_delta_fields(jnp.asarray(cp), log2w, log2h, n_cp)
    for g, w_ in zip(got, want, strict=True):
        _eq(g, w_)


def test_apply_prof_all_phase_pairs():
    win, xf, yf = _windows()
    dh = RNG.integers(-31, 32, size=(256, 16)).astype(np.int32)
    dv = RNG.integers(-31, 32, size=(256, 16)).astype(np.int32)
    dh[:4], dv[:4] = 31, -31
    pred = tinterp.filter_windows(_t(win), _t(xf), _t(yf), last=False)
    jpred = jinterp.filter_windows(jnp.asarray(win), jnp.asarray(xf),
                                   jnp.asarray(yf), last=False)
    _eq(tprof.apply_prof(pred, _t(win), _t(xf), _t(yf), _t(dh), _t(dv)),
        jprof.apply_prof(jpred, jnp.asarray(win), jnp.asarray(xf),
                         jnp.asarray(yf), jnp.asarray(dh), jnp.asarray(dv)))


def _same_tables(got, want):
    """The port's StageTables equal the JAX ones field by field."""
    assert got._fields == want._fields
    for f in ("n_ctus", "n_cus"):
        assert getattr(got, f) == getattr(want, f), f
    for f in tme._TENSOR_DTYPES:
        _eq(getattr(got, f), getattr(want, f))
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        assert g._fields == w._fields
        for f in ("offset", "n_cus", "w", "h", "log2w", "log2h"):
            assert getattr(g, f) == getattr(w, f), f
        _eq(g.sub_x, w.sub_x)
        _eq(g.sub_y, w.sub_y)
        for a, b in zip(g.factors, w.factors, strict=True):
            _eq(a, b)


@pytest.mark.parametrize("mode", ["full", "half"])
@pytest.mark.parametrize("fw,fh,pad", [(256, 128, 0), (200, 136, 0),
                                       (200, 136, 8)])
def test_build_tables_match_jax(mode, fw, fh, pad):
    spec_j = jme.StageSpec(mode, 3, fw, fh)
    want = jme.build_tables(spec_j, n_ctu_pad=pad)
    got = tme.build_tables(tme.StageSpec(mode, 3, fw, fh), n_ctu_pad=pad,
                           device="cpu")
    _same_tables(got, want)
    _same_tables(tme.tables_from_numpy(want._asdict(), "cpu"), want)
    if pad:
        assert got.n_ctus == pad and not got.within[4:].any()


def test_extra_gradient_iter_matches_the_plane_stage():
    """--ExtraGradientIter (affine.cl:173-177): the gather stage with one
    extra round equals the plane stage with one, and differs from none."""
    fw = fh = 128
    orig, recon = testing.affine_gop(fw, fh, 1, seed=7)
    z = tap.zero_cpmvs(tap.PlaneSpec("full", 2, fw, fh), "cpu")
    args = tap.stage_inputs_from_numpy(recon[0], orig[0], 78.949063, z,
                                       "cpu")
    got = tme.build_stage(tme.StageSpec("full", 2, fw, fh, extra_iters=1),
                          "cpu")(*args)
    want = tap.build_stage(tap.PlaneSpec("full", 2, fw, fh, extra_iters=1),
                           "cpu")(*args)
    assert [g.dtype for g in got] == [torch.int64, torch.int32]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    base = tme.build_stage(tme.StageSpec("full", 2, fw, fh), "cpu")(*args)
    assert not torch.equal(base[0], got[0])
