"""The port's native host runtime (``vvc_affine_tpu_torch/native``).

* The native CSV parse equals the plain Python parser and the JAX
  package's reader; out-of-range, malformed and short files raise with the
  row; a missing file raises OSError.
* The native decision-row bytes equal the plain writer's
  (``reporting.format_rows``) and those of the JAX package's own native
  library, through ``report_results`` too (files and terminal).
* The library is built into the package's ``_build/``; a failed build
  raises.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from vvc_affine_tpu import native as jax_native
from vvc_affine_tpu.runtime import frames as jax_frames
from vvc_affine_tpu_torch import native
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.runtime import reporting

# One intra-op thread, as in the other port tests.
torch.set_num_threads(1)

RNG = np.random.default_rng(29)


def test_parse_matches_the_plain_parser_and_jax(tmp_path):
    data = RNG.integers(0, 1024, size=(3, 48, 64)).astype(np.uint16)
    data[0, 0, :4] = (0, 1023, 7, 10)
    path = str(tmp_path / "f.csv")
    frames_io.write_frames_csv(path, data)
    # extra columns and rows beyond the frames are legal and ignored
    with open(path, "a") as f:
        f.write("1,2,3\n")
    got = frames_io.read_frames_csv(path, 64, 48, 3)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(
        frames_io.read_frames_csv_plain(path, 64, 48, 3), data)
    np.testing.assert_array_equal(jax_frames.read_frames_csv(path, 64, 48, 3),
                                  data)
    np.testing.assert_array_equal(frames_io.read_frames_csv(path, 60, 40, 1),
                                  data[:1, :40, :60])


@pytest.mark.parametrize("rows,bad_row", [
    (["1,2,3,4", "5,70000,7,8"], 1),            # > 65535
    (["1,2,3,4", "5,4294967296,7,8"], 1),       # wraps uint32 to 0
    (["1,2,x,4", "5,6,7,8"], 0),                # a field with no digits
    (["1,2,3,4", "5,6,,8"], 1),                 # an empty field
    (["1,2,3,4", "5,6,7"], 1),                  # a short row
    (["1,2,3,4"], 1),                           # a short file
])
def test_native_parse_rejects_bad_files_with_the_row(tmp_path, rows,
                                                     bad_row):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    with pytest.raises(ValueError, match=f"at row {bad_row} "):
        native.parse_luma_csv(path, 2, 4)
    with pytest.raises(ValueError):
        frames_io.read_frames_csv(path, 4, 2, 1)


def test_missing_file_raises_oserror(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_luma_csv(str(tmp_path / "none.csv"), 1, 1)
    meta = np.zeros((1, 7), np.int32)
    with pytest.raises(OSError, match="decision log"):
        native.append_decision_rows(str(tmp_path / "no" / "log.csv"), meta,
                                    np.zeros(1, np.int64),
                                    np.zeros((1, 6), np.int32))


def _rows(n):
    meta = RNG.integers(-(1 << 31), 1 << 31, size=(n, 7)).astype(np.int32)
    cost = RNG.integers(-(1 << 62), 1 << 62, size=n).astype(np.int64)
    cost[:2] = (np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max)
    cpmv = RNG.integers(-(1 << 31), 1 << 31, size=(n, 6)).astype(np.int32)
    meta[0], cpmv[0] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    return meta, cost, cpmv


def test_decision_rows_equal_the_plain_and_jax_writers(tmp_path):
    meta, cost, cpmv = _rows(9000)     # more than one 4096-row buffer
    path = str(tmp_path / "t.csv")
    native.append_decision_rows(path, meta[:5], cost[:5], cpmv[:5],
                                write_header=True)
    native.append_decision_rows(path, meta[5:], cost[5:], cpmv[5:])
    # the JAX package's library, built here from its own source (its
    # get_lib builds next to the source, which other test processes share)
    so = str(tmp_path / "libjax.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", so,
                    jax_native._SRC], check=True, timeout=300)
    lib = ctypes.CDLL(so)
    jpath = str(tmp_path / "j.csv")
    for lo, hi, head in ((0, 5, 1), (5, 9000, 0)):
        m, c, v = (np.ascontiguousarray(a[lo:hi]) for a in (meta, cost, cpmv))
        assert lib.vvc_append_decision_rows(
            ctypes.c_char_p(jpath.encode()), ctypes.c_int32(head),
            ctypes.c_int64(hi - lo),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) == 0
    with open(path, "rb") as a, open(jpath, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    header = "POC,List,Ref,CTU,idx,X,Y,Cost,LT_X,LT_Y,RT_X,RT_Y,LB_X,LB_Y\n"
    assert got == (header + reporting.format_rows(meta, cost, cpmv)).encode()
    with pytest.raises(ValueError, match="shapes"):
        native.append_decision_rows(path, meta[:3], cost[:2], cpmv[:3])


def test_report_results_native_and_terminal_bytes(tmp_path, capsys):
    """``report_results`` writes the same bytes natively and, with
    ``to_terminal``, through the plain writer, which it also prints."""
    rng = np.random.default_rng(5)
    for pred, n_cu in ((1, 201), (2, 284)):
        costs = rng.integers(0, 1 << 40, size=(3, n_cu)).astype(np.int64)
        cpmvs = rng.integers(-5000, 5000, size=(3, n_cu, 3, 2)).astype(
            np.int32)
        for poc, ref in ((1, 0), (2, 1)):
            reporting.report_results(str(tmp_path / "n"), pred, 300, costs,
                                     cpmvs, poc, ref)
            reporting.report_results(str(tmp_path / "p"), pred, 300, costs,
                                     cpmvs, poc, ref, to_terminal=True)
        printed = capsys.readouterr().out
        total = b""
        for npath, ppath in zip(
                reporting.log_paths(str(tmp_path / "n"), pred),
                reporting.log_paths(str(tmp_path / "p"), pred)):
            with open(npath, "rb") as a, open(ppath, "rb") as b:
                data = a.read()
                assert data == b.read(), npath
            total += data.split(b"\n", 1)[1]
        assert sorted(printed.encode().splitlines()) == sorted(
            total.splitlines())


def test_library_builds_into_the_package_build_dir():
    native.get_lib()
    so = native._so_path()
    assert os.path.dirname(so) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.exists(so)
    assert not [f for f in os.listdir(os.path.dirname(native.SOURCE))
                if f.endswith(".so")]


@pytest.mark.parametrize("how", ["no g++", "compile error"])
def test_failed_build_raises(monkeypatch, tmp_path, how):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    if how == "no g++":
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "g\\+\\+ not found"
    else:
        bad = tmp_path / "vvc_native.cpp"
        bad.write_text("int broken( {\n")
        monkeypatch.setattr(native, "SOURCE", str(bad))
        match = "g\\+\\+ failed"
    with pytest.raises(RuntimeError, match=match):
        native.get_lib()
    with pytest.raises(RuntimeError, match=match):
        frames_io.read_frames_csv(str(tmp_path / "f.csv"), 1, 1, 1)
    assert native._lib is None
