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


# K1's design (csrc/warp.cu): its dp2a filter and its staged regions

_WINDOWS = {
    "zeros": np.zeros((9, 9)),
    "max": np.full((9, 9), 1023),
    "alt_cols": np.tile([0, 1023], (9, 5))[:, :9],
    "alt_cols_inv": np.tile([1023, 0], (9, 5))[:, :9],
    "alt_rows": np.tile([[0], [1023]], (5, 9))[:9],
    "alt_rows_inv": np.tile([[1023], [0]], (5, 9))[:9],
    "random": np.random.default_rng(7).integers(0, 1024, size=(9, 9)),
}


@pytest.mark.parametrize("par", [0, 1])
@pytest.mark.parametrize("window", sorted(_WINDOWS))
def test_filter_dp2a_matches_int32_filter(window, par):
    """The kernel's filter, two-way dot products of int16 sample pairs and
    int8 taps (a numpy-exact model of ``__dp2a_lo/hi``), equals
    ``filter_blocks`` in int32 for all 16x16 phase pairs on the extreme
    10-bit windows, at both parities of the window's first column."""
    win = torch.from_numpy(np.broadcast_to(
        _WINDOWS[window], (16, 16, 9, 9)).astype(np.int32))
    bank = torch.from_numpy(twarp.BANK6)
    hc = bank[:, None].expand(16, 16, 6)
    vc = bank[None, :].expand(16, 16, 6)
    want = twarp.filter_blocks(win, hc, vc)
    got = twarp.filter_blocks_dp2a(win, hc, vc, par)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _edge_field(rng, shape, past):
    """Windows exactly at (past 0) or one sample past (1) an edge of the
    strip's staged region; each strip's centre block keeps the strip's
    random displacement."""
    n = shape[:2] + (4,)
    out = []
    for blk, m, hi in ((4 * np.arange(8)[:, None], twarp.MY, twarp.RH - 9),
                       (4 * np.arange(32)[None, :], twarp.MX, twarp.RW - 9)):
        # one centre per group of bins: the group shares its region
        g = twarp.group_bins(n[1])
        c = rng.integers(-40, 41, size=(n[0], -(-n[1] // g), 4, 1, 1))
        c = np.repeat(c, g, axis=1)[:, :n[1]]
        w = np.where(rng.random(n + (8, 32)) < 0.5, -past, hi + past)
        d = c + w - blk - m
        d[..., 4, 16] = c[..., 0, 0]
        out.append(d.reshape(shape).astype(np.int32))
    return out


def _staging_field(name, seed):
    near = name.startswith("past_")         # within every region's margin
    ref, ctu_y, ctu_x, dy, dx, fx, fy = _inputs(seed, 3, 3 if near else 8,
                                                0.0 if near else 0.05)
    rng = np.random.default_rng(seed)
    if name == "far300":
        d = rng.integers(-300, 301, size=(2,) + dy.shape)
        dy, dx = np.where(rng.random(d.shape) < 0.3, d, (dy, dx)).astype(
            np.int32)
    elif name.startswith("region_edge"):
        dy, dx = _edge_field(rng, dy.shape, int(name[-1]))
    elif name.startswith("past_"):
        side = name[5:]
        dy = dy + {"top": -FH, "bottom": FH}.get(side, 0)
        dx = dx + {"left": -FW, "right": FW}.get(side, 0)
    return ref, ctu_y, ctu_x, dy, dx, fx, fy


@pytest.mark.parametrize("field", ["near", "far300", "region_edge0",
                                   "region_edge1", "past_top", "past_bottom",
                                   "past_left", "past_right"])
def test_staged_warp_matches_jax_warp_xla(field):
    """A mirror of K1's tile staging (``warp_staged``: each strip's region
    read with clamped coordinates, the staged blocks' windows from it, the
    others from the frame) reproduces the JAX ``warp_xla`` at |d| up to 300
    and at every frame edge of the 200x136 frame (every CTU, so every strip
    that touches a frame border)."""
    ref, ctu_y, ctu_x, dy, dx, fx, fy = _staging_field(field, 31)
    t = [torch.from_numpy(a) for a in (ref, ctu_y, ctu_x, dy, dx, fx, fy)]
    got = twarp.warp_staged(t[0], FW, FH, *t[1:5], twarp.tap_planes(t[5]),
                            twarp.tap_planes(t[6]))
    want = np.asarray(jwarp.warp_xla(
        jnp.asarray(ref), FW, FH, jnp.asarray(ctu_y), jnp.asarray(ctu_x),
        jnp.asarray(dy), jnp.asarray(dx), _jax_taps(fx), _jax_taps(fy)))
    np.testing.assert_array_equal(got.numpy(), want)
    ry0, rx0, staged = twarp.staging_plan(*t[1:5])
    share = float(staged.float().mean())
    if field == "region_edge0" or field.startswith("past_"):
        assert share == 1.0
    elif field == "region_edge1":       # all but each strip's centre block
        assert share == pytest.approx(1 / 256)
    else:
        assert 0.0 < share < 1.0


def test_staging_plan_rule():
    """A block is staged exactly when its 9x9 window lies inside its
    strip's RH x RW region."""
    _, ctu_y, ctu_x, dy, dx, _, _ = _staging_field("far300", 3)
    ry0, rx0, staged = (v.numpy() for v in twarp.staging_plan(
        *(torch.from_numpy(a) for a in (ctu_y, ctu_x, dy, dx))))
    by = 4 * np.arange(32)[:, None]
    bx = 4 * np.arange(32)[None, :]
    y0 = ctu_y[:, None, None, None] + by + dy - 2
    x0 = ctu_x[:, None, None, None] + bx + dx - 2
    s = np.repeat(np.arange(4), 8)[:, None]
    oy = y0 - np.take_along_axis(ry0, np.broadcast_to(s, (32, 32))
                                 .reshape(1, 1, -1), axis=2).reshape(dy.shape)
    ox = x0 - np.take_along_axis(rx0, np.broadcast_to(s, (32, 32))
                                 .reshape(1, 1, -1), axis=2).reshape(dy.shape)
    inside = ((oy >= 0) & (oy + 9 <= twarp.RH) & (ox >= 0)
              & (ox + 9 <= twarp.RW))
    np.testing.assert_array_equal(staged, inside)
    assert inside.any() and not inside.all()
