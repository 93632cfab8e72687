"""The native host runtime (``vvc_native.cpp``): CSV frame ingest and the
decision-log writer, bound with ``ctypes``.

The library is built with ``g++ -O3 -shared -fPIC`` at first use into the
package's ``_build/`` directory (listed in ``.gitignore``), keyed by a
sha256 of the source and the flags: a library whose key does not match is
never loaded, and no binary is kept next to the source.  A failed build
raises; nothing falls back to the Python parser or writer.  The C ABI of
``vvc_parse_luma_csv`` and ``vvc_append_decision_rows`` is the JAX
package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "vvc_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _so_path() -> str:
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libvvcnative-{key.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile the library into ``so``; raise RuntimeError on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the native runtime library "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so, use_errno=True)
            lib.vvc_parse_luma_csv.restype = ctypes.c_int64
            lib.vvc_parse_luma_csv.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int64, ctypes.c_int64]
            lib.vvc_append_decision_rows.restype = ctypes.c_int64
            lib.vvc_append_decision_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
                _I32P, _I64P, _I32P]
            _lib = lib
        return _lib


def _io_error(what: str, path: str) -> OSError:
    err = ctypes.get_errno()
    if err:
        return OSError(err, f"{what}: {os.strerror(err)}", path)
    return OSError(f"{what}: {path}")


def parse_luma_csv(path: str, rows: int, cols: int) -> np.ndarray:
    """The first ``cols`` samples of the first ``rows`` lines of a CSV as
    uint16 [rows, cols].

    Raises ValueError, naming the row, for a file that ends early, a field
    with no digits or a value above 65535; OSError when the file cannot be
    opened or mapped.
    """
    lib = get_lib()
    out = np.empty((rows, cols), np.uint16)
    ctypes.set_errno(0)
    rc = lib.vvc_parse_luma_csv(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rows, cols)
    if rc <= -2:
        raise ValueError(f"{path}: malformed/oversized field or short file at "
                         f"row {-(rc + 2)} (need {rows} rows)")
    if rc != 0:
        raise _io_error("cannot open or map the CSV", path)
    return out


def append_decision_rows(path: str, meta: np.ndarray, cost: np.ndarray,
                         cpmv: np.ndarray, write_header: bool = False) -> None:
    """Append one decision-log row per entry to ``path`` (with
    ``write_header``: truncate it and write the header first).

    meta: int32 [n, 7] (POC, List, Ref, CTU, idx, X, Y); cost: int64 [n];
    cpmv: int32 [n, 6].  A failed write leaves the file as it was and
    raises OSError.
    """
    meta = np.ascontiguousarray(meta, np.int32)
    cost = np.ascontiguousarray(cost, np.int64)
    cpmv = np.ascontiguousarray(cpmv, np.int32)
    n = cost.shape[0]
    if meta.shape != (n, 7) or cost.shape != (n,) or cpmv.shape != (n, 6):
        raise ValueError(f"decision rows: shapes {meta.shape}, {cost.shape}, "
                         f"{cpmv.shape}; want [n, 7], [n], [n, 6]")
    lib = get_lib()
    ctypes.set_errno(0)
    rc = lib.vvc_append_decision_rows(
        os.fsencode(path), int(write_header), n,
        meta.ctypes.data_as(_I32P), cost.ctypes.data_as(_I64P),
        cpmv.ctypes.data_as(_I32P))
    if rc != 0:
        raise _io_error("cannot write the decision log", path)
