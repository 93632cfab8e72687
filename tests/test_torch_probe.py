"""The port's window probes equal the six Pallas probe kernels of
``tools/mosaic_probe.py``.

The JAX tool builds its kernels inside ``main()``.  The fixture loads the
tool by path, runs ``main()`` with ``pl.pallas_call`` wrapped so that every
kernel runs in interpret mode and each built callable is kept, then calls
those callables again on a numpy-seeded tile at the tool's offset and at the
edges of each probe's defined range.  The port's plain version, its wrapper
(on CPU tensors) and the numpy window must equal them exactly.  The tool
itself is not edited.
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.tools import mosaic_probe as mp

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "mosaic_probe.py")


@pytest.fixture(scope="module")
def pallas_probes():
    """kernel name -> the tool's pallas_call, built with interpret=True."""
    spec = importlib.util.spec_from_file_location("_mosaic_probe_tool", _TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    real = pl.pallas_call
    built = {}

    def interpreted(kernel, *args, **kw):
        fn = real(kernel, *args, **dict(kw, interpret=True))
        built[kernel.__name__] = fn
        return fn

    out = io.StringIO()
    pl.pallas_call = interpreted
    try:
        with contextlib.redirect_stdout(out):
            tool.main()
    finally:
        pl.pallas_call = real
    printed = out.getvalue()
    assert printed.count(": PASS") == 6 and "FAIL" not in printed, printed
    assert sorted(built) == sorted(mp.PROBES)
    return built


def _tile(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1024, mp.X_SHAPE).astype(np.int16)


@pytest.mark.parametrize("name", list(mp.PROBES))
def test_probe_matches_pallas_interpret(pallas_probes, name):
    x = _tile(7)
    xt = torch.from_numpy(x)
    for s in mp.CASES[name]:
        with jax.enable_x64(False):
            want = np.asarray(pallas_probes[name](
                np.asarray([[s]], np.int32), x))
        assert want.dtype == np.int32 and want.shape == mp.OUT_SHAPE
        for got in (mp.probe_plain(name, xt, s), mp.probe(name, xt, s)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} s={s}")
        np.testing.assert_array_equal(mp.expected(name, x, s), want,
                                      err_msg=f"{name} s={s} (numpy)")


@pytest.mark.parametrize("name,s", [("k_a", -1), ("k_a", 22), ("k_e", -1),
                                    ("k_e", 129), ("k_b", 2**32 + 13),
                                    ("k_c", 2**31), ("k_d_rows", -2**31 - 1),
                                    ("k_d_lanes", 2**40)])
def test_probe_refuses_undefined_offsets(name, s):
    xt = torch.from_numpy(_tile(1))
    with pytest.raises(ValueError, match="undefined"):
        mp.probe(name, xt, s)
    with pytest.raises(ValueError, match="undefined"):
        mp.probe_plain(name, xt, s)


def test_probe_tool_passes_and_fails_on_a_wrong_window(monkeypatch, capsys):
    assert mp.main([], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count(": PASS") == 6 and "probe done" in out
    real = mp.probe_plain
    monkeypatch.setattr(mp, "probe_plain", lambda name, x, s: real(
        name, x, s) + int(name == "k_c"))
    assert mp.main([], device="cpu") == 1
    out = capsys.readouterr().out
    assert "c_roll_lanes_dyn: FAIL" in out and out.count(": PASS") == 5


def test_each_probe_has_its_kernel_and_launch_counter():
    for name in mp.PROBES:
        src, sym, kinds = kernels._KERNELS[f"probe_{name}"]
        assert (src, sym, kinds) == ("window_probe.cu", f"vvc_probe_{name}",
                                     "ppi")
        assert kernels.launches[f"probe_{name}"] == 0
