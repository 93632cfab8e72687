"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` process per source, all started together,
and is keyed by a sha256 of the source and the flags: a library whose key
does not match is never loaded.  The libraries live in ``_build/`` next to
this file (listed in ``.gitignore``).  A failed build raises; nothing falls
back to the plain versions.

Every C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; the launcher that ``bind`` returns raises
when that is not 0 and counts the launch in ``launches``, the only place a
kernel launch is counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> (source, C symbol, argument kinds: p = pointer, i = int)
_KERNELS = {
    "warp": ("warp.cu", "vvc_warp", "ppppppppp" + "iiii"),
    "blockreduce": ("blockreduce.cu", "vvc_blockreduce", "ppppp" + "iii"),
    **{f"probe_{p}": ("window_probe.cu", f"vvc_probe_{p}", "ppi")
       for p in ("k_a", "k_b", "k_c", "k_d_rows", "k_d_lanes", "k_e")},
    # an empty kernel of the probes' shape: the floor of a launch
    "empty_launch": ("window_probe.cu", "vvc_empty_launch", ""),
}

# launches of each kernel since the last reset_launches()
launches: Dict[str, int] = {name: 0 for name in _KERNELS}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # source -> nvcc/ptxas output


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return path


def _so_path(src: str) -> str:
    with open(os.path.join(_CSRC, src), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()[:16]}.so")


def build(sources: Optional[tuple] = None) -> float:
    """Compile every missing library (all nvcc runs in parallel).

    Returns the wall seconds spent; raises RuntimeError with the compiler's
    output when any build fails.
    """
    if sources is None:
        sources = tuple(sorted({v[0] for v in _KERNELS.values()}))
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in sources if not os.path.exists(_so_path(s))]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            so = _so_path(src)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, so, tmp, p in procs:
            out, _ = p.communicate(timeout=600)
            build_log[src] = out
            if p.returncode != 0:
                failed.append(f"{src}:\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _function(name: str):
    src, sym, kinds = _KERNELS[name]
    with _lock:
        lib = _libs.get(src)
    if lib is None:
        build((src,))
        with _lock:
            lib = _libs.setdefault(src, ctypes.CDLL(_so_path(src)))
    fn = getattr(lib, sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                   for k in kinds] + [ctypes.c_void_p]
    return fn


def check(t: torch.Tensor, dtype, shape, name: str, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape
    (on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def bind(name: str, device: torch.device, *args):
    """Kernel ``name`` bound to ``args`` on ``device``'s current stream.

    ``args`` are tensors (passed as device pointers), None (a null pointer)
    or ints, in the order of the C entry point; the caller keeps the
    tensors alive.  Returns a callable that launches the kernel once per
    call, counting each launch; the arguments are converted only here.
    """
    fn = _function(name)
    c_args = []
    for a in args:
        if isinstance(a, torch.Tensor):
            c_args.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            c_args.append(ctypes.c_void_p(None))
        else:
            c_args.append(ctypes.c_int(int(a)))
    c_args.append(ctypes.c_void_p(torch.cuda.current_stream(device)
                                  .cuda_stream))

    def run() -> None:
        with torch.cuda.device(device):
            rc = fn(*c_args)
        if rc != 0:
            raise RuntimeError(
                f"kernel {name} failed to launch: CUDA error {rc}")
        launches[name] += 1

    return run
