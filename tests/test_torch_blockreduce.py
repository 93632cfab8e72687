"""K2's plain version (``reduce_blocks_plain``) equals the JAX package's.

Against the TPU kernel ``reduce_pallas`` in interpret mode, its output folded
to block form as the JAX engine folds it (``affine_plane.py:817-835``), and
against the JAX engine's unfused reduction ``_reduce_pred`` per CU.  Both
modes, refine on and off, and the one-bin broadcast of the zero-motion
iteration.  Exact equality on the valid slots of in-frame CUs (outputs are
unspecified elsewhere) and on every per-CU output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vvc_affine_tpu.models import affine_plane as jap
from vvc_affine_tpu.ops import blockreduce as jbr
from vvc_affine_tpu.ops import blockstat as jbs
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import blockreduce as tbr

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default pool (a thread per core in every worker) oversubscribes
# the CPU and slows these many small ops many times over.
torch.set_num_threads(1)

FW, FH = 200, 136          # 2x2 CTUs, the right and bottom ones partial


def _valid_slots(jt):
    """bool [nCtu, nBins, 32, 32]: slots of in-frame CUs (JAX tables)."""
    out = np.zeros((jt.n_ctus, jt.n_bins, 32, 32), bool)
    for ci, cp_tab in enumerate(jt.cls):
        s = jt.strides[ci]
        w = jnp.asarray(jt.within[:, s:s + cp_tab.num_cus].astype(np.int32))
        cover = np.asarray(jap.P.spread_cu_to_slots(jnp, w, cp_tab)) > 0
        out[:, int(jt.bin_of[ci])] |= cover & cp_tab.slot_valid
    return out


def _inputs(n_ctu, pred_bins, seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 1024, size=(n_ctu, pred_bins, 128, 128)).astype(
        np.int16)
    orig = rng.integers(0, 1024, size=(n_ctu, 128, 128)).astype(np.int32)
    return pred, orig


def _cases():
    return [(m, b, r) for m in ("full", "half") for b, r in
            (("all", True), ("all", False), ("one", True))]


@pytest.mark.parametrize("mode,bins,refine", _cases())
def test_reduce_blocks_matches_pallas_interpret(mode, bins, refine):
    jspec = jap.PlaneSpec(mode, 2, FW, FH)
    jt = jap.build_tables(jspec)
    pred, orig = _inputs(jt.n_ctus, jt.n_bins if bins == "all" else 1,
                         seed=len(mode) + 2 * refine)
    satd_l, moms_l = jbr.reduce_pallas(
        jnp.asarray(pred), jnp.asarray(orig.astype(np.int16)),
        jnp.asarray(jt.border_packed), jnp.asarray(jt.slab_active), refine,
        interpret=True)
    satd_want = np.asarray(satd_l)[..., 3::4]
    satd, moms = tbr.reduce_blocks_plain(
        torch.from_numpy(pred), torch.from_numpy(orig),
        torch.from_numpy(jt.border_packed), refine)
    valid = _valid_slots(jt)
    assert satd.dtype == torch.int32 and valid.any()
    np.testing.assert_array_equal(np.where(valid, satd.numpy(), 0),
                                  np.where(valid, satd_want, 0))
    if not refine:
        assert moms is None and moms_l is None
        return
    m = np.asarray(moms_l)
    moms_want = m[..., 0::4] + m[..., 1::4] + m[..., 2::4] + m[..., 3::4]
    assert moms.dtype == torch.int32
    np.testing.assert_array_equal(
        np.where(valid[:, :, None], moms.numpy(), 0),
        np.where(valid[:, :, None], moms_want, 0))


@pytest.mark.parametrize("mode,bins,refine", _cases())
def test_reduce_pred_matches_jax_unfused(mode, bins, refine):
    """Per-CU SATD and normal equations through the port's engine tail
    (``reduce_blocks`` + slot->CU folds + ``_assemble_equations``)."""
    n_cp = 3 if bins == "all" else 2
    jspec = jap.PlaneSpec(mode, n_cp, FW, FH, use_pallas=False)
    jt = jap.build_tables(jspec)
    pred, orig = _inputs(jt.n_ctus, jt.n_bins if bins == "all" else 1,
                         seed=10 + len(mode) + 2 * refine)
    want = jap._reduce_pred(
        jspec, jt, jnp.asarray(pred),
        jap._orig_forms(jspec, jnp.asarray(orig)), jnp.asarray(jt.within),
        refine)
    tspec = tap.PlaneSpec(mode, n_cp, FW, FH)
    got = tap._reduce_pred(tspec, tap.build_tables(tspec, "cpu"),
                           torch.from_numpy(pred), torch.from_numpy(orig),
                           refine)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["full", "half"])
def test_replication_flags_reproduce_sobel_replicated(mode):
    """K2's per-block replication flags, derived from the JAX tables'
    border masks, give on random planes the gradients of
    ``_sobel_replicated`` (the per-sample mask rule) for every bin."""
    jt = jap.build_tables(jap.PlaneSpec(mode, 2, FW, FH))
    border = torch.from_numpy(jt.border_packed)
    flags = tbr.replication_flags(border)
    assert flags.dtype == torch.uint8 and flags.shape == (jt.n_bins, 32, 32)
    assert int(flags.max()) <= 15 and flags.bool().any()
    rng = np.random.default_rng(len(mode))
    plane = torch.from_numpy(rng.integers(
        0, 1024, size=(2, jt.n_bins, 128, 128)).astype(np.int32))
    masks = [(border & bit) != 0 for bit in
             (tbr.TOP, tbr.BOT, tbr.LEFT, tbr.RIGHT)]
    none = torch.zeros_like(masks[0])
    raw = tbr._sobel_replicated(plane, none, none, none, none)
    want = tbr._sobel_replicated(plane, *masks)
    for r, w in zip(raw, want):
        assert not torch.equal(r, w)
        assert torch.equal(tbr.replicate_blocks(r, flags), w)


def test_replication_flags_refuse_masks_off_the_block_grid():
    """A CU border off the 4-sample grid has sources outside the block:
    the flags cannot express it, and the derivation refuses."""
    border = torch.zeros((1, 128, 128), dtype=torch.int32)
    border[0, 8:24, 10] = tbr.LEFT
    with pytest.raises(ValueError, match="4x4"):
        tbr.replication_flags(border)
    border[0, 8:24, 10] = 0
    border[0, 8:24, 8] = tbr.LEFT
    assert int(tbr.replication_flags(border)[0, 2:6, 2].min()) == tbr.LEFT


@pytest.mark.parametrize("mode", ["full", "half"])
def test_reduce_blocks_plain_matches_blockstat(mode):
    """K2's plain version against the JAX package's ``ops/blockstat.py``
    (the exact MXU-form block sums behind ``PlaneSpec.mxu_reduce``):
    ``satd_blocks`` of every (CTU, bin) plane, and ``block_sums_i64`` of
    the five moment products of the replicated Sobel gradients
    (``_sobel_replicated`` with each bin's masks), equal everywhere.  The
    port keeps no copy of blockstat: on the card K2 computes these sums in
    int32."""
    jt = jap.build_tables(jap.PlaneSpec(mode, 2, FW, FH))
    pred, orig = _inputs(jt.n_ctus, jt.n_bins, seed=20 + len(mode))
    satd, moms = tbr.reduce_blocks_plain(
        torch.from_numpy(pred), torch.from_numpy(orig),
        torch.from_numpy(jt.border_packed), True)
    orig_j = jnp.asarray(orig)
    np.testing.assert_array_equal(
        satd.numpy(),
        np.asarray(jbs.satd_blocks(orig_j[:, None], jnp.asarray(pred))))
    for bi in range(jt.n_bins):
        plane = jnp.asarray(pred[:, bi].astype(np.int32))
        gx, gy = jap._sobel_replicated(
            plane, jt.bin_row_top[bi], jt.bin_row_bot[bi],
            jt.bin_col_left[bi], jt.bin_col_right[bi])
        err = orig_j - plane
        prods = jnp.stack([gx * gx, gx * gy, gy * gy, gx * err, gy * err],
                          axis=1)
        want = np.asarray(jbs.block_sums_i64(prods))
        assert want.dtype == np.int64
        np.testing.assert_array_equal(moms[:, bi].numpy().astype(np.int64),
                                      want)
