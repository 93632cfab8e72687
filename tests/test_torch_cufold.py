"""The CU fold kernel's design, held on the CPU (``csrc/cufold.cu``).

On a card ``affine_plane._fold_cu`` launches one kernel per evaluate: one
thread per (CTU, lane), a lane being one block column of one CU
(``planes.fold_lane_table``, ``PlaneTables.fold_lanes``), which sums the
column's SATD (where the block is of the CU's class) and 24 moment sums
weighted by the slot centres of ``planes.bin_slot_table`` in int64; the
CU's lanes add their sums in a butterfly of warp shuffles and store M and
rhs formed from them.  The CPU has no kernel, so these tests hold its
design against the plain version (``_fold_cu_plain``, which the stage and
block-reduction tests hold against the JAX package):

* the lane table, for both modes and on unpadded, padded and ``ctu_rows``
  tables, gives every canonical CU once, as the rectangle, class and bin
  that ``planes`` implies, and the block table gives the slot centres and
  ``slot_valid`` the plain version reads;
* a numpy mirror of the kernel's per-lane arithmetic, butterfly and
  stores, reading those tables, equals the plain version exactly for FULL
  and HALF, 2CP and 3CP, refine and SATD-only: on random K2 outputs with
  moments at +-2^29 and SATD at the int32 extremes, on K2's output for the
  zero-CPMV iteration (``_evaluate_zero``), and with out-of-frame CUs
  (1080p's bottom CTU row, the padding CTUs);
* the engine sends CUDA tensors to the kernel's wrapper, and the wrapper
  refuses the wrong dtype, shape, device, contiguity and ``n_cp`` before
  anything is launched.

That the kernel computes the mirror's function bit for bit only the card
shows (``chip_smoke.py``, phase 5c).
"""

import functools

import numpy as np
import pytest
import torch

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch import planes as P
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.ops import cufold

FW, FH = 1920, 1080
MODES = ["full", "half"]
# the kernel's linear model over (1, cx, cy) (csrc/cufold.cu coef_a/coef_b)
FORMS = {
    3: ([(1, 0, 0), (0, 1, 0), (0, 0, 0), (0, 0, 0), (0, 0, 1), (0, 0, 0)],
        [(0, 0, 0), (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 0), (0, 0, 1)]),
    2: ([(1, 0, 0), (0, 1, 0), (0, 0, 0), (0, 0, 1)],
        [(0, 0, 0), (0, 0, 1), (1, 0, 0), (0, -1, 0)]),
}
ROW = {name: i for i, name in enumerate(P.LANE_ROWS)}


@functools.lru_cache(maxsize=None)
def _tables(mode, layout, fw=FW, fh=FH):
    """Tables: as built, padded by three CTUs, or the padded tables' CTUs
    from a third of the frame's on (``ctu_rows``, as a shard of the split
    takes them)."""
    spec = tap.PlaneSpec(mode, 2, fw, fh)
    if layout == "plain":
        return tap.build_tables(spec, "cpu")
    n = tap.build_tables(spec, "cpu").n_ctus
    if layout == "padded":
        return tap.build_tables(spec, "cpu", n_ctu_pad=n + 3)
    return tap.ctu_rows(_tables(mode, "padded", fw, fh), n // 3, n + 3)


def _mono(i, j):
    i, j = min(i, j), max(i, j)
    return j if i == 0 else 2 + j if i == 1 else 5


def _entries(S, n_cp):
    """The CU's entries from its 25 sums, in the kernel's order: SATD, M
    row-major, rhs (each int64 [...])."""
    a, b = FORMS[n_cp]
    pn = 2 * n_cp
    out = [S[24]]
    for p in range(pn):
        for q in range(pn):
            v = np.zeros_like(S[0])
            for i in range(3):
                for j in range(3):
                    k = _mono(i, j)
                    v += a[p][i] * a[q][j] * S[k]
                    v += (a[p][i] * b[q][j] + a[q][i] * b[p][j]) * S[6 + k]
                    v += b[p][i] * b[q][j] * S[12 + k]
            out.append(v)
    for p in range(pn):
        v = sum(a[p][i] * S[18 + i] + b[p][i] * S[21 + i] for i in range(3))
        out.append(v << 3)
    return out


def _emulate(t, satd_b, moms_b, n_cp, refine):
    """The kernel in numpy int64: per (CTU, lane) the column sums, the
    butterfly over each CU's aligned lanes, and each lane's stores, every
    output entry stored exactly once."""
    lanes = t.fold_lanes.numpy()
    slots = t.mv_slots.numpy()
    cu, cls, bn, by0, bx, sbh, sbw = (lanes[ROW[r]] for r in P.LANE_ROWS)
    n_lanes = lanes.shape[1]
    assert n_lanes % 32 == 0
    live = t.within.numpy()[:, cu]
    b = bn
    sat = satd_b.numpy()
    mom = moms_b.numpy() if refine else None
    S = np.zeros((25, t.n_ctus, n_lanes), np.int64)
    for r in range(P.NB):
        on = live & (r < sbh)[None]
        y = np.where(r < sbh, by0 + r, 0)
        valid = slots[P.SLOT_ROWS.index("cls"), b, y, bx] == cls
        S[24] += np.where(on & valid[None], sat[:, b, y, bx], 0)
        if not refine:
            continue
        cx = slots[P.SLOT_ROWS.index("cx"), b, y, bx].astype(np.int64)
        cy = slots[P.SLOT_ROWS.index("cy"), b, y, bx].astype(np.int64)
        w = [np.ones_like(cx), cx, cy, cx * cx, cx * cy, cy * cy]
        for k in range(5):
            m = np.where(on, mom[:, b, k, y, bx], 0).astype(np.int64)
            for i in range(6 if k < 3 else 3):
                S[6 * k + i if k < 3 else 18 + 3 * (k - 3) + i] += m * w[i]
    idx = np.arange(n_lanes)
    o = 1
    while o < 32:
        S = S + np.where(o < sbw, S[:, :, idx ^ o], 0)
        o *= 2
    entries = _entries(S, n_cp) if refine else [S[24]]
    out = np.zeros((len(entries), t.n_ctus, t.n_cus), np.int64)
    count = np.zeros(out.shape, np.int64)
    j = idx & (sbw - 1)
    for e, v in enumerate(entries):
        st = (e & (sbw - 1)) == j
        out[e][:, cu[st]] = v[:, st]
        count[e][:, cu[st]] += 1
    assert (count == 1).all()       # every entry of every CU stored once
    satd = out[0]
    if not refine:
        return satd, None, None
    pn = 2 * n_cp
    M = out[1:1 + pn * pn].transpose(1, 2, 0).reshape(
        t.n_ctus, t.n_cus, pn, pn)
    rhs = out[1 + pn * pn:].transpose(1, 2, 0)
    return satd, M, rhs


def _k2_random(t, seed):
    """Random K2 outputs: SATD over the int32 range with its extremes,
    moments over [-2^29, 2^29] with both ends."""
    rng = np.random.default_rng(seed)
    shape = (t.n_ctus, t.n_bins, P.NB, P.NB)
    satd = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    pick = rng.random(shape)
    satd[pick < 0.2] = 2**31 - 1
    satd[pick > 0.8] = -2**31
    moms = rng.integers(-2**29, 2**29 + 1, size=shape[:2] + (5,) + shape[2:])
    pick = rng.random(moms.shape)
    moms[pick < 0.2] = 2**29
    moms[pick > 0.8] = -2**29
    return (torch.from_numpy(satd.astype(np.int32)),
            torch.from_numpy(moms.astype(np.int32)))


def _check(spec, t, satd_b, moms_b, refine):
    want = tap._fold_cu_plain(spec, t, satd_b, moms_b, refine)
    got = _emulate(t, satd_b, moms_b if refine else None, spec.n_cp, refine)
    for name, g, w in zip(("satd", "M", "rhs"), got, want, strict=True):
        if w is None:
            assert g is None
            continue
        assert w.dtype == torch.int64
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # the engine's entry point runs the plain version on the CPU
    for g, w in zip(tap._fold_cu(spec, t, satd_b, moms_b if refine else None,
                                 refine), want, strict=True):
        assert (g is None and w is None) or torch.equal(g, w)
    return want


@pytest.mark.parametrize("layout", ["plain", "padded", "rows"])
@pytest.mark.parametrize("mode", MODES)
def test_fold_lane_table_matches_the_class_layout(mode, layout):
    t = _tables(mode, layout)
    lanes = t.fold_lanes.numpy()
    assert t.fold_lanes.dtype == torch.int32
    np.testing.assert_array_equal(lanes, P.fold_lane_table(mode))
    if layout == "rows":     # the static tables are shared, not copied
        assert t.fold_lanes is _tables(mode, "padded", FW, FH).fold_lanes
        assert t.mv_slots is _tables(mode, "padded", FW, FH).mv_slots
    cu, cls, bn, by0, bx, sbh, sbw = (lanes[ROW[r]] for r in P.LANE_ROWS)
    assert lanes.shape[1] % 32 == 0
    cls_tab = t.mv_slots.numpy()[P.SLOT_ROWS.index("cls")]
    cx_tab = t.mv_slots.numpy()[P.SLOT_ROWS.index("cx")]
    cy_tab = t.mv_slots.numpy()[P.SLOT_ROWS.index("cy")]
    seen = set()
    for ci, cp_tab in enumerate(t.cls):
        b = int(t.bin_of[ci])
        ids = torch.arange(1, cp_tab.num_cus + 1, dtype=torch.int32)
        spread = P.spread_cu_to_slots(ids, cp_tab,
                                      t.cls_t[ci].cu_index).numpy()
        # the block table's class is slot_valid of each class of the bin,
        # and its centres are the class's slot_cx, slot_cy there
        v = cp_tab.slot_valid
        np.testing.assert_array_equal(cls_tab[b] == ci, v)
        np.testing.assert_array_equal(cx_tab[b][v], cp_tab.slot_cx[v])
        np.testing.assert_array_equal(cy_tab[b][v], cp_tab.slot_cy[v])
        for k in range(cp_tab.num_cus):
            c = t.strides[ci] + k
            at = np.flatnonzero(cu == c)
            ys, xs = np.nonzero(spread == k + 1)
            h, w = cp_tab.height // 4, cp_tab.width // 4
            # one lane per column, in order, aligned to the CU's width
            assert len(at) == w and at[0] % w == 0
            np.testing.assert_array_equal(at, at[0] + np.arange(w))
            np.testing.assert_array_equal(bx[at], xs.min() + np.arange(w))
            assert (cls[at] == ci).all() and (bn[at] == b).all()
            assert (by0[at] == ys.min()).all() and (sbh[at] == h).all()
            assert (sbw[at] == w).all() and h % 4 == 0
            assert ys.max() - ys.min() + 1 == h and len(ys) == h * w
            assert v[ys, xs].all()
            seen.add(c)
    # every lane is one column of one CU
    assert seen == set(range(t.n_cus)) and lanes.shape[1] == sum(
        c.num_cus * c.width // 4 for c in t.cls)


@pytest.mark.parametrize("n_cp", [2, 3])
def test_kernel_forms_equal_the_equation_factors(n_cp):
    """The kernel's a_p, b_p over (1, cx, cy) are ``_factor_planes``'."""
    cp_tab = P.plane_layout("half")[5]
    a, b = tap._factor_planes(cp_tab, n_cp)
    u = (1, cp_tab.slot_cx.astype(np.int64), cp_tab.slot_cy.astype(np.int64))
    fa, fb = FORMS[n_cp]
    for p in range(2 * n_cp):
        np.testing.assert_array_equal(a[p], sum(fa[p][i] * u[i]
                                                for i in range(3)))
        np.testing.assert_array_equal(b[p], sum(fb[p][i] * u[i]
                                                for i in range(3)))


@pytest.mark.parametrize("n_cp,refine", [(2, True), (3, True), (2, False)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arithmetic_equals_the_plain_version(mode, n_cp, refine):
    t = _tables(mode, "plain")
    # the 1080p bottom CTU row holds out-of-frame CUs
    assert not t.within.all() and t.within.any()
    spec = tap.PlaneSpec(mode, n_cp, FW, FH)
    satd_b, moms_b = _k2_random(t, seed=10 * n_cp + refine + len(mode))
    M = _check(spec, t, satd_b, moms_b, refine)[1]
    if refine:     # the extremes reach past int32 in the sums
        assert M.abs().max() > 2**40


@pytest.mark.parametrize("layout", ["padded", "rows"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arithmetic_on_padded_and_row_tables(mode, layout):
    """The split's tables at 640x360 (a partial bottom CTU row): padding
    CTUs (no in-frame CU) are zero, and a shard's row views fold the
    same."""
    t = _tables(mode, layout, 640, 360)
    spec = tap.PlaneSpec(mode, 3, 640, 360)
    satd_b, moms_b = _k2_random(t, seed=7 + len(layout))
    satd, M, rhs = _check(spec, t, satd_b, moms_b, True)
    pad = slice(t.n_ctus - 3, None)      # the padding CTUs come last
    assert not t.within[pad].any()
    assert not (satd[pad].any() or M[pad].any() or rhs[pad].any())


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_arithmetic_on_the_zero_cpmv_iteration(mode, refine,
                                                      monkeypatch):
    """K2's outputs of ``_evaluate_zero`` on seeded frames with partial
    CTUs at the right and bottom, taken where the engine folds them."""
    fw, fh = 272, 200
    spec = tap.PlaneSpec(mode, 2, fw, fh)
    t = _tables(mode, "plain", fw, fh)
    assert not t.within.all()
    rng = np.random.default_rng(31 + refine)
    ref, orig, _, _ = tap.stage_inputs_from_numpy(
        rng.integers(0, 1024, fw * fh), rng.integers(0, 1024, fw * fh), 1.0,
        np.zeros((t.n_ctus, t.n_cus, 3, 2)), "cpu")
    orig_pl, ref_pl = tap.prep_inputs(spec, t, ref, orig)
    seen = []
    plain = tap._fold_cu

    def fold(*args):
        seen.append(args[2:4])
        return plain(*args)

    monkeypatch.setattr(tap, "_fold_cu", fold)
    tap._evaluate_zero(spec, t, ref_pl, orig_pl, refine)
    (satd_b, moms_b), = seen
    assert (moms_b is not None) == refine and satd_b.any()
    for n_cp in (2, 3) if refine else (2,):
        _check(tap.PlaneSpec(mode, n_cp, fw, fh), t, satd_b, moms_b, refine)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card as its device, so that the
    wrapper's checks past the device check run on the CPU."""

    @property
    def device(self):
        return torch.device("cuda:0")


def _inputs(t):
    return dict(satd_b=torch.zeros((t.n_ctus, t.n_bins, P.NB, P.NB),
                                   dtype=torch.int32),
                moms_b=torch.zeros((t.n_ctus, t.n_bins, 5, P.NB, P.NB),
                                   dtype=torch.int32),
                within=t.within, lanes=t.fold_lanes, slots=t.mv_slots)


@pytest.mark.parametrize("field,bad,err", [
    ("satd_b", lambda x: x.long(), TypeError),
    ("moms_b", lambda x: x.long(), TypeError),
    ("within", lambda x: x.to(torch.uint8), TypeError),
    ("lanes", lambda x: x.to(torch.int16), TypeError),
    ("slots", lambda x: x.to(torch.int16), TypeError),
    ("satd_b", lambda x: x[:-1], ValueError),
    ("moms_b", lambda x: x[:, :, :4], ValueError),
    ("lanes", lambda x: x[:6], ValueError),
    ("lanes", lambda x: x[:, :-16], ValueError),
    ("slots", lambda x: x[:5], ValueError),
    ("moms_b", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("within", lambda x: x.t().contiguous().t(), ValueError),
])
def test_wrapper_refuses_wrong_inputs(field, bad, err, monkeypatch):
    monkeypatch.setattr(kernels, "bind", lambda *a: pytest.fail("bound"))
    t = _tables("half", "plain")
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    args[field] = bad(args[field]).as_subclass(_OnCard)
    with pytest.raises(err, match=field):
        cufold.fold_cu(**args, n_cp=3, refine=True)


def test_wrapper_refuses_the_cpu_other_n_cp_and_stray_moments(monkeypatch):
    monkeypatch.setattr(kernels, "bind", lambda *a: pytest.fail("bound"))
    t = _tables("full", "plain")
    with pytest.raises(ValueError, match="within: expected a tensor on cuda"):
        cufold.fold_cu(**_inputs(t), n_cp=2, refine=True)
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    args["satd_b"] = _inputs(t)["satd_b"]      # one input left on the CPU
    with pytest.raises(ValueError, match="satd_b: expected a tensor on"):
        cufold.fold_cu(**args, n_cp=3, refine=True)
    with pytest.raises(ValueError, match="n_cp"):
        cufold.fold_cu(**_inputs(t), n_cp=4, refine=True)
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    with pytest.raises(ValueError, match="moms_b: expected None"):
        cufold.fold_cu(**args, n_cp=2, refine=False)


def test_engine_sends_card_tensors_to_the_kernel(monkeypatch):
    """``_fold_cu`` on CUDA tensors calls the wrapper, never the plain
    version (here a CPU tensor reporting a card stands in)."""
    t = _tables("full", "plain")
    spec = tap.PlaneSpec("full", 3, FW, FH)
    calls = []
    monkeypatch.setattr(tap, "_fold_cu_plain",
                        lambda *a: pytest.fail("plain fold on a card"))
    monkeypatch.setattr(cufold, "fold_cu",
                        lambda *a: calls.append(a) or ("out",))
    args = {k: v.as_subclass(_OnCard) for k, v in _inputs(t).items()}
    assert tap._fold_cu(spec, t, args["satd_b"], args["moms_b"], True) == \
        ("out",)
    (call,) = calls
    assert call[2] is t.within and call[3] is t.fold_lanes
    assert call[4] is t.mv_slots and call[5:] == (3, True)
