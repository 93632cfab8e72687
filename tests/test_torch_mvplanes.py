"""The motion-plane kernel's design, held on the CPU (``csrc/mvplanes.cu``).

On a card ``affine_plane._mv_planes`` launches one kernel per evaluate,
which reads each block's CU from a static per-(bin, block) table
(``planes.bin_slot_table``, ``PlaneTables.mv_slots``) and computes the
block's motion in int32 that wraps as PyTorch's does.  The CPU has no
kernel, so these tests hold its design against the plain version
(``_mv_planes_plain``, which the stage tests hold against the JAX package):

* the table, for both modes and on unpadded, padded and ``ctu_rows``
  tables, equals the class, CU, sub-block centre and coverage that
  ``planes.spread_cu_to_slots`` and ``slot_cx`` / ``slot_cy`` imply;
* a numpy mirror of the kernel's per-block arithmetic, reading that table,
  equals the plain version exactly for 2CP and 3CP on random CPMVs, CPMVs
  at +-MV_MAX, CUs spread over the limit, zero CPMVs, and out-of-frame CUs
  (1080p's bottom CTU row, the padding CTUs);
* the kernel's wrapper refuses the wrong dtype, shape, device, contiguity
  and ``n_cp`` before anything is launched.

That the kernel computes the mirror's function bit for bit only the card
shows (``chip_smoke.py``, phase 15).
"""

import functools

import numpy as np
import pytest
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch import planes as P
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import mv as mv_ops
from vvc_affine_tpu_torch.ops import mvplanes

FW, FH = 1920, 1080
MODES = ["full", "half"]
KINDS = ["random", "mv_max", "spread", "zero", "mixed"]


@functools.lru_cache(maxsize=None)
def _tables(mode, layout):
    """1080p tables: as built, padded by three CTUs, or CTUs 40..137 of the
    padded tables (``ctu_rows``, as a shard of the split takes them)."""
    spec = tap.PlaneSpec(mode, 2, FW, FH)
    if layout == "plain":
        return tap.build_tables(spec, "cpu")
    if layout == "padded":
        return tap.build_tables(spec, "cpu", n_ctu_pad=138)
    return tap.ctu_rows(_tables(mode, "padded"), 40, 138)


def _cpmvs(t, kind, seed):
    """int32 [nCtu, nCU, 3, 2] CPMVs of one kind."""
    rng = np.random.default_rng(seed)
    shape = (t.n_ctus, t.n_cus, 3, 2)
    if kind == "random":
        cp = rng.integers(-3000, 3001, size=shape)
    elif kind == "mv_max":
        cp = rng.choice([C.MV_MIN, C.MV_MAX, -C.MV_MAX], size=shape)
    elif kind == "spread":
        # RT and LB far from LT: the deltas put every CU over the limit
        lt = rng.integers(-500, 501, size=shape[:2] + (1, 2))
        off = rng.integers(2000, 8000, size=shape) * rng.choice([-1, 1],
                                                               size=shape)
        cp = lt + off
        cp[:, :, 0] = lt[:, :, 0]
    elif kind == "zero":
        cp = np.zeros(shape)
    else:     # the kinds above mixed per CU
        parts = [_cpmvs(t, k, seed + i).numpy()
                 for i, k in enumerate(KINDS[:4])]
        pick = rng.integers(0, 4, size=shape[:2])
        cp = np.choose(pick[..., None, None], parts)
    return torch.as_tensor(np.clip(cp, C.MV_MIN, C.MV_MAX).astype(np.int32))


def _emulate(spec, t, cpmvs):
    """The kernel's per-block arithmetic in numpy int32 (which wraps mod
    2^32 as the kernel's uint32 arithmetic does): per (CTU, bin, block) the
    table's CU, its deltas, spread test, MV at the sub-block or CU centre,
    rounding and clip; zero where uncovered or out of frame."""
    slots = t.mv_slots.numpy()
    cu = slots[P.SLOT_ROWS.index("cu")]                       # [nB, NB, NB]
    cov = cu >= 0
    c = np.where(cov, cu, 0)
    live = t.within.numpy()[:, c] & cov                 # [nCtu, nB, NB, NB]
    cp = cpmvs.numpy()[:, c]                      # [nCtu, nB, NB, NB, 3, 2]
    log2w, log2h = slots[4], slots[5]
    sw = np.where(cov, 7 - log2w, 0).astype(np.int32)
    sh = np.where(cov, 7 - log2h, 0).astype(np.int32)
    lt, rt, lb = cp[..., 0, :], cp[..., 1, :], cp[..., 2, :]
    hx = (rt[..., 0] - lt[..., 0]) << sw
    hy = (rt[..., 1] - lt[..., 1]) << sw
    if spec.n_cp == 3:
        vx = (lb[..., 0] - lt[..., 0]) << sh
        vy = (lb[..., 1] - lt[..., 1]) << sh
    else:
        vx, vy = -hy, hx
    i32 = np.int32

    def absw(v):
        return np.maximum(i32(0), v) - np.minimum(i32(0), v)

    s4 = i32(4 << 11)
    rw = (absw(i32(4) * hx + s4) >> 11) + i32(9)
    rh = (absw(i32(4) * hy) >> 11) + i32(9)
    spread = rw * rh > 165
    rw = (absw(i32(4) * vx) >> 11) + i32(9)
    rh = (absw(i32(4) * vy + s4) >> 11) + i32(9)
    spread |= rw * rh > 165
    half_w = (1 << np.maximum(log2w - 1, 0)).astype(np.int32)
    half_h = (1 << np.maximum(log2h - 1, 0)).astype(np.int32)
    cx = np.where(spread, half_w, slots[2]).astype(np.int32)
    cy = np.where(spread, half_h, slots[3]).astype(np.int32)
    mvx = (lt[..., 0] << i32(7)) + hx * cx + vx * cy
    mvy = (lt[..., 1] << i32(7)) + hy * cx + vy * cy

    def rnd(v):
        return (v + i32(64) - (v >= 0).astype(np.int32)) >> 7

    def clip(v, pos, size):
        return np.minimum(np.maximum(v, (i32(-128 - 8 + 1) - pos) << 4),
                          (i32(size + 8 - 1) - pos) << 4)

    mvx = clip(rnd(mvx), t.abs_x.numpy()[:, c], spec.frame_w)
    mvy = clip(rnd(mvy), t.abs_y.numpy()[:, c], spec.frame_h)
    return tuple(np.where(live, v, 0).astype(np.int32)
                 for v in (mvy >> 4, mvx >> 4, mvx & 15, mvy & 15))


@pytest.mark.parametrize("layout", ["plain", "padded", "rows"])
@pytest.mark.parametrize("mode", MODES)
def test_slot_table_matches_the_class_layout(mode, layout):
    t = _tables(mode, layout)
    tab = t.mv_slots.numpy()
    assert t.mv_slots.dtype == torch.int32
    assert tab.shape == (len(P.SLOT_ROWS), t.n_bins, P.NB, P.NB)
    np.testing.assert_array_equal(tab, P.bin_slot_table(mode))
    if layout == "rows":     # the static tables are shared, not copied
        assert t.mv_slots is _tables(mode, "padded").mv_slots
    want = np.zeros_like(tab)
    want[:2] = -1
    covered = np.zeros((t.n_bins, P.NB, P.NB), np.int32)
    for ci, cp_tab in enumerate(t.cls):
        b = int(t.bin_of[ci])
        ids = torch.arange(1, cp_tab.num_cus + 1, dtype=torch.int32)
        spread = P.spread_cu_to_slots(ids, cp_tab,
                                      t.cls_t[ci].cu_index).numpy()
        on = spread > 0
        np.testing.assert_array_equal(on, cp_tab.slot_valid)
        covered[b] += on
        want[0, b][on] = ci
        want[1, b][on] = t.strides[ci] + spread[on] - 1
        want[2, b][on] = cp_tab.slot_cx[on]
        want[3, b][on] = cp_tab.slot_cy[on]
        want[4, b][on] = np.log2(cp_tab.width)
        want[5, b][on] = np.log2(cp_tab.height)
    assert covered.max() == 1       # the classes of a bin are disjoint
    np.testing.assert_array_equal(tab, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_cp", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arithmetic_equals_the_plain_version(mode, n_cp, kind):
    t = _tables(mode, "plain")
    spec = tap.PlaneSpec(mode, n_cp, FW, FH)
    cp = _cpmvs(t, kind, seed=100 * n_cp + KINDS.index(kind))
    # the 1080p bottom CTU row holds out-of-frame CUs
    assert not t.within.all() and t.within.any()
    if kind == "spread":
        spread = [mv_ops.is_spread_over_limit(*mv_ops.affine_deltas(
            cp[:, t.strides[ci]:t.strides[ci] + c.num_cus],
            int(np.log2(c.width)), int(np.log2(c.height)), n_cp))
            for ci, c in enumerate(t.cls)]
        assert torch.cat(spread, dim=1).float().mean() > 0.9
    want = tap._mv_planes_plain(spec, t, cp)
    got = _emulate(spec, t, cp)
    for name, g, w in zip(mvplanes.PLANES, got, want, strict=True):
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # the engine's entry point runs the plain version on the CPU
    for g, w in zip(tap._mv_planes(spec, t, cp), want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["padded", "rows"])
@pytest.mark.parametrize("n_cp", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arithmetic_on_padded_and_row_tables(mode, n_cp, layout):
    """The split's tables: padding CTUs (no in-frame CU) are zero, and a
    shard's row views give the same per-block motion."""
    t = _tables(mode, layout)
    spec = tap.PlaneSpec(mode, n_cp, FW, FH)
    cp = _cpmvs(t, "mixed", seed=7 + n_cp)
    want = tap._mv_planes_plain(spec, t, cp)
    got = _emulate(spec, t, cp)
    for name, g, w in zip(mvplanes.PLANES, got, want, strict=True):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    pad = slice(t.n_ctus - 3, None)      # the padding CTUs come last
    assert not t.within[pad].any()
    assert all(not w[pad].any() for w in want)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card as its device, so that the
    wrapper's checks past the device check run on the CPU."""

    @property
    def device(self):
        return torch.device("cuda:0")


def _inputs(t):
    return dict(cpmvs=torch.zeros((t.n_ctus, t.n_cus, 3, 2),
                                  dtype=torch.int32),
                abs_x=t.abs_x, abs_y=t.abs_y, within=t.within,
                slots=t.mv_slots)


@pytest.mark.parametrize("field,bad,err", [
    ("cpmvs", lambda x: x.long(), TypeError),
    ("abs_x", lambda x: x.long(), TypeError),
    ("within", lambda x: x.to(torch.uint8), TypeError),
    ("slots", lambda x: x.to(torch.int16), TypeError),
    ("cpmvs", lambda x: x[:-1], ValueError),
    ("abs_y", lambda x: x[:, :-1], ValueError),
    ("slots", lambda x: x[:5], ValueError),
    ("cpmvs", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("within", lambda x: x.t().contiguous().t(), ValueError),
])
def test_wrapper_refuses_wrong_inputs(field, bad, err, monkeypatch):
    monkeypatch.setattr(kernels, "bind", lambda *a: pytest.fail("bound"))
    t = _tables("full", "plain")
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    args[field] = bad(args[field]).as_subclass(_OnCard)
    with pytest.raises(err, match=field):
        mvplanes.mv_planes(**args, n_cp=2, frame_w=FW, frame_h=FH)


def test_wrapper_refuses_the_cpu_and_other_n_cp(monkeypatch):
    monkeypatch.setattr(kernels, "bind", lambda *a: pytest.fail("bound"))
    t = _tables("half", "plain")
    with pytest.raises(ValueError, match="abs_x: expected a tensor on cuda"):
        mvplanes.mv_planes(**_inputs(t), n_cp=2, frame_w=FW, frame_h=FH)
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    args["cpmvs"] = _inputs(t)["cpmvs"]      # one input left on the CPU
    with pytest.raises(ValueError, match="cpmvs: expected a tensor on"):
        mvplanes.mv_planes(**args, n_cp=3, frame_w=FW, frame_h=FH)
    with pytest.raises(ValueError, match="n_cp"):
        mvplanes.mv_planes(**_inputs(t), n_cp=4, frame_w=FW, frame_h=FH)
