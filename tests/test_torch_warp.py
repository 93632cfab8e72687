"""K1's plain version (the port's ``warp_xla``) equals the JAX package's.

Against the JAX ``warp_xla`` for displacements far beyond the TPU kernel's
bound (|d| up to 300, so windows run past every frame edge), and against the
TPU kernel ``warp_pallas`` itself in interpret mode within its bound R, as
tests/test_warp.py runs it.  Exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vvc_affine_tpu import geometry as JG
from vvc_affine_tpu.models import affine_plane as jap
from vvc_affine_tpu.ops import warp as jwarp
from vvc_affine_tpu_torch.ops import warp as twarp

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

FW, FH = 200, 136          # 2x2 CTUs, the right and bottom ones partial


def _inputs(seed, n_cls, dmax, far=0.0):
    rng = np.random.default_rng(seed)
    grid = JG.frame_grid(FW, FH)
    n_ctu = grid.num_ctus
    ctu_x, ctu_y = (v.astype(np.int32) for v in grid.ctu_origin())
    shape = (n_ctu, n_cls, 32, 32)
    ref = rng.integers(0, 1024, size=FH * FW).astype(np.int32)
    d = rng.integers(-dmax, dmax + 1, size=(2,) + shape)
    if far:
        big = rng.integers(-300, 301, size=(2,) + shape)
        d = np.where(rng.random((2,) + shape) < far, big, d)
    dy, dx = d.astype(np.int32)
    fx, fy = rng.integers(0, 16, size=(2,) + shape).astype(np.int32)
    return ref, ctu_y, ctu_x, dy, dx, fx, fy


def _torch_warp(ref, ctu_y, ctu_x, dy, dx, fx, fy):
    t = [torch.from_numpy(a) for a in (ref, ctu_y, ctu_x, dy, dx, fx, fy)]
    return twarp.warp_xla(t[0], FW, FH, *t[1:5], twarp.tap_planes(t[5]),
                          twarp.tap_planes(t[6]))


def _jax_taps(f):
    return jap._tap_planes(jnp.asarray(f), jnp.int16)


def test_tap_planes_match_jax():
    f = np.random.default_rng(0).integers(0, 16, size=(3, 4, 32, 32)).astype(
        np.int32)
    got = twarp.tap_planes(torch.from_numpy(f))
    want = np.asarray(_jax_taps(f))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dmax,far", [(3, 0.0), (40, 0.2)])
def test_warp_xla_matches_jax(dmax, far):
    ref, ctu_y, ctu_x, dy, dx, fx, fy = _inputs(1 + dmax, 3, dmax, far)
    got = _torch_warp(ref, ctu_y, ctu_x, dy, dx, fx, fy)
    want = np.asarray(jwarp.warp_xla(
        jnp.asarray(ref), FW, FH, jnp.asarray(ctu_y), jnp.asarray(ctu_x),
        jnp.asarray(dy), jnp.asarray(dx), _jax_taps(fx), _jax_taps(fy)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if far:
        assert np.abs(dy).max() > 16 and np.abs(dx).max() > 16


@pytest.mark.parametrize("R", [2, 8])
def test_warp_xla_matches_pallas_interpret(R):
    """Within its bound R the TPU kernel computes the same planes."""
    ref, ctu_y, ctu_x, dy, dx, fx, fy = _inputs(20 + R, 2, R)
    grid = JG.frame_grid(FW, FH)
    jref = jnp.asarray(ref)
    tiles = jwarp.build_tiles(
        jwarp.build_refpad(jref, FW, FH, grid.ctu_rows, grid.ctu_cols),
        grid.ctu_rows, grid.ctu_cols)
    want = np.asarray(jwarp.warp_pallas(
        tiles, jwarp.expand_lanes(jnp.asarray(dy)),
        jwarp.expand_lanes(jnp.asarray(dx)),
        jwarp.expand_lanes(_jax_taps(fx)), jwarp.expand_lanes(_jax_taps(fy)),
        R=R, interpret=True))
    got = _torch_warp(ref, ctu_y, ctu_x, dy, dx, fx, fy)
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors ``warp`` runs ``warp_xla`` on the looked-up taps over
    every slab (slab_active is only a work mask) and returns int16."""
    ref, ctu_y, ctu_x, dy, dx, fx, fy = _inputs(5, 2, 20, 0.1)
    t = [torch.from_numpy(a) for a in (ref, ctu_y, ctu_x, dy, dx, fx, fy)]
    act = torch.zeros((dy.shape[0], 2, 16), dtype=torch.int32)
    got = twarp.warp(t[0], FW, FH, *t[1:], act)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(
        got.numpy(), _torch_warp(ref, ctu_y, ctu_x, dy, dx, fx, fy).numpy())
