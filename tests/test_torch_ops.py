"""The port's integer and float64 ops equal the JAX package's, exactly.

Inputs are made with numpy from a seed (the ranges tests/test_ops.py uses)
and fed to both; every output must be equal in value and dtype-class.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vvc_affine_tpu.ops import cost as jcost
from vvc_affine_tpu.ops import mv as jmv
from vvc_affine_tpu.ops import satd as jsatd
from vvc_affine_tpu.ops import solver as jsolver
from vvc_affine_tpu.utils import bitmath as jbit
from vvc_affine_tpu_torch.ops import cost as tcost
from vvc_affine_tpu_torch.ops import mv as tmv
from vvc_affine_tpu_torch.ops import satd as tsatd
from vvc_affine_tpu_torch.ops import solver as tsolver
from vvc_affine_tpu_torch.utils import bitmath as tbit

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

RNG = np.random.default_rng(17)


def _eq(got, want):
    """Torch ``got`` equals JAX/numpy ``want`` exactly (NaN-free here)."""
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape
    assert g.dtype.kind == w.dtype.kind and g.dtype.itemsize == w.dtype.itemsize
    np.testing.assert_array_equal(g, w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cpmvs(n, lo=-2000, hi=2000):
    return RNG.integers(lo, hi, size=(n, 3, 2)).astype(np.int32)


def test_bitmath():
    v = RNG.integers(-(1 << 28), 1 << 28, size=4096).astype(np.int32)
    for shift in (1, 2, 4, 7):
        _eq(tbit.round_shift(_t(v), shift), jbit.round_shift(jnp.asarray(v),
                                                             shift))
    x = np.concatenate([[1, 2, 3, 4, 255, 256, 1 << 30],
                        RNG.integers(1, 1 << 31, size=1000)]).astype(np.int32)
    _eq(tbit.floor_log2(_t(x)), jbit.floor_log2(jnp.asarray(x)))
    lo = RNG.integers(-100, 0, size=4096).astype(np.int32)
    _eq(tbit.clamp(_t(v), -5000, 7000), jbit.clamp(jnp.asarray(v), -5000, 7000))
    _eq(tbit.clamp(_t(v), _t(lo), 50),
        jbit.clamp(jnp.asarray(v), jnp.asarray(lo), 50))


def test_round_and_clip_mv():
    n = 2048
    mv = RNG.integers(-(1 << 20), 1 << 20, size=(n, 2)).astype(np.int32)
    px = RNG.integers(0, 1920, size=n).astype(np.int32)
    py = RNG.integers(0, 1080, size=n).astype(np.int32)
    got = tmv.round_and_clip_mv(_t(mv[:, 0]), _t(mv[:, 1]), _t(px), _t(py),
                                1920, 1080)
    want = jmv.round_and_clip_mv(mv[:, 0], mv[:, 1], px, py, 1920, 1080)
    for g, w in zip(got, want):
        _eq(g, w)
    got = tmv.clip_mv(_t(mv[:, 0]), _t(mv[:, 1]), _t(px), _t(py), 1920, 1080)
    want = jmv.clip_mv(jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]),
                       jnp.asarray(px), jnp.asarray(py), 1920, 1080)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n_cp", [2, 3])
@pytest.mark.parametrize("w,h", [(128, 128), (64, 32), (16, 16), (8, 32)])
def test_mv_derivations(n_cp, w, h):
    n = 96
    # large CPMVs so the spread path triggers
    cp = np.concatenate([_cpmvs(n - 16), _cpmvs(16, -60000, 60000)])
    lw, lh = int(np.log2(w)), int(np.log2(h))
    sh, sw = h // 4, w // 4
    sub_x = np.tile(np.arange(sw) * 4, sh).astype(np.int32)
    sub_y = np.repeat(np.arange(sh) * 4, sw).astype(np.int32)
    got = tmv.derive_sub_mvs(_t(cp), lw, lh, n_cp, _t(sub_x), _t(sub_y))
    want = jmv.derive_sub_mvs(jnp.asarray(cp), lw, lh, n_cp,
                              jnp.asarray(sub_x), jnp.asarray(sub_y))
    assert bool(np.asarray(want[2]).any())
    for g, w_ in zip(got, want):
        _eq(g, w_)
    got = tmv.affine_deltas(_t(cp), lw, lh, n_cp)
    want = jmv.affine_deltas(jnp.asarray(cp), lw, lh, n_cp)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    _eq(tmv.is_spread_over_limit(*got), jmv.is_spread_over_limit(*want))
    cux = RNG.integers(0, 1920, size=n).astype(np.int32)
    cuy = RNG.integers(0, 1080, size=n).astype(np.int32)
    _eq(tmv.derive_lb_from_2cp(_t(cp), lw, lh, _t(cux), _t(cuy), 1920, 1080),
        jmv.derive_lb_from_2cp(jnp.asarray(cp), lw, lh, jnp.asarray(cux),
                               jnp.asarray(cuy), 1920, 1080))
    v = RNG.integers(-(1 << 20), 1 << 20, size=512).astype(np.int32)
    _eq(tmv.change_precision_to_quarter(_t(v)),
        jmv.change_precision_to_quarter(jnp.asarray(v)))
    _eq(tmv.round_affine_prec_quarter(_t(v)),
        jmv.round_affine_prec_quarter(jnp.asarray(v)))


@pytest.mark.parametrize("sample_axis", [-1, -2])
def test_satd(sample_axis):
    a = RNG.integers(0, 1024, size=(3, 16, 257)).astype(np.int32)
    b = RNG.integers(0, 1024, size=(3, 16, 257)).astype(np.int32)
    if sample_axis == -1:
        a, b = a.swapaxes(1, 2), b.swapaxes(1, 2)
    _eq(tsatd.satd_4x4(_t(a), _t(b), sample_axis=sample_axis),
        jsatd.satd_4x4(jnp.asarray(a), jnp.asarray(b),
                       sample_axis=sample_axis))


def test_cost():
    vals = np.concatenate(
        [np.array([0, 1, -1, 2, -2, 64, 65, -65, 128, 129]),
         RNG.integers(-(1 << 17), 1 << 17, size=500)]).astype(np.int32)
    _eq(tcost.exp_golomb_bits(_t(vals)), jcost.exp_golomb_bits(
        jnp.asarray(vals)))
    for n_cp in (2, 3):
        cp = _cpmvs(256, -100000, 100000)
        _eq(tcost.affine_bits_zero_pred(_t(cp), n_cp),
            jcost.affine_bits_zero_pred(jnp.asarray(cp), n_cp))
    satd = RNG.integers(0, 1 << 20, size=300).astype(np.int64)
    bits = RNG.integers(0, 400, size=300).astype(np.int32)
    for lam in (78.949063, 17.583905, 708.938619, 57.54):
        got = tcost.rd_cost(_t(satd), _t(bits),
                            torch.tensor(np.float32(lam)))
        _eq(got, jcost.rd_cost(jnp.asarray(satd), jnp.asarray(bits), lam))


def test_rd_cost_refuses_float64_lambda():
    """A float64 lambda would promote the product and change costs."""
    with pytest.raises(TypeError):
        tcost.rd_cost(torch.zeros(1, dtype=torch.int64),
                      torch.zeros(1, dtype=torch.int32),
                      torch.tensor(57.54, dtype=torch.float64))


def _systems(n_cp, n):
    P = 2 * n_cp
    out = []
    for i in range(n):
        if i % 6 == 0:
            A = np.zeros((P, P + 1), np.int64)       # 0/0 NaN, dead pivots
        elif i % 6 == 1:
            A = RNG.integers(-5, 5, size=(P, P + 1)).astype(np.int64)
        elif i % 6 == 2:
            # near-singular: two almost parallel rows of a PSD system
            ic = RNG.integers(-(1 << 18), 1 << 18, size=(64, P))
            ic[:, 1] = ic[:, 0] + RNG.integers(-1, 2, size=64)
            A = np.zeros((P, P + 1), np.int64)
            A[:, :P] = ic.T @ ic
            A[:, P] = RNG.integers(-(1 << 40), 1 << 40, size=P)
        elif i % 6 == 3:
            A = np.zeros((P, P + 1), np.int64)       # one live row only
            A[0, 0] = RNG.integers(1, 1 << 20)
            A[0, P] = RNG.integers(-(1 << 30), 1 << 30)
        else:
            ic = RNG.integers(-(1 << 18), 1 << 18, size=(64, P)).astype(
                np.int64)
            A = np.zeros((P, P + 1), np.int64)
            A[:, :P] = ic.T @ ic
            A[:, P] = RNG.integers(-(1 << 40), 1 << 40, size=P)
        out.append(A)
    return np.stack(out)


@pytest.mark.parametrize("n_cp", [2, 3])
def test_solver(n_cp):
    P = 2 * n_cp
    A = _systems(n_cp, 240).reshape(4, 60, P, P + 1)   # batched, not flat
    got = tsolver.solve_affine(_t(A[..., :P]), _t(A[..., P]), n_cp)
    want = np.asarray(jsolver.solve_affine(jnp.asarray(A[..., :P]),
                                           jnp.asarray(A[..., P]), n_cp))
    assert got.dtype == torch.float64
    # bit equality, NaN where JAX has NaN
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))


def test_argmax_first_occurrence_and_nan():
    """The solver's pivot search relies on argmax returning the first
    maximum and counting NaN as the maximum, as jnp.argmax does."""
    rows = np.array([[1.0, 3.0, 3.0, 0.0],
                     [-np.inf, -np.inf, -np.inf, -np.inf],
                     [0.0, np.nan, 5.0, np.nan],
                     [np.nan, np.nan, 1.0, 2.0],
                     [-0.0, 0.0, 0.0, -np.inf]])
    np.testing.assert_array_equal(torch.argmax(_t(rows), dim=-1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(rows),
                                                        axis=-1)))


@pytest.mark.parametrize("n_cp", [2, 3])
def test_scale_delta_mvs(n_cp):
    P = 2 * n_cp
    n = 256
    params = RNG.normal(scale=2.0, size=(n, P))
    params[0] = 0.0
    params[1, 0] = np.nan                      # NaN maps to 0
    params[2] = np.nan
    params[3, -1] = 1e12                       # clipped to the int32 range
    params[4, 0] = -1e12
    w = RNG.choice([8, 16, 32, 64, 128], size=n).astype(np.int32)
    h = RNG.choice([8, 16, 32, 64, 128], size=n).astype(np.int32)
    _eq(tsolver.scale_delta_mvs(_t(params), n_cp, _t(w), _t(h)),
        jsolver.scale_delta_mvs(jnp.asarray(params), n_cp, jnp.asarray(w),
                                jnp.asarray(h)))
