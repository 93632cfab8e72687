"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` process per source, all started together,
and is keyed by a sha256 of the source and the flags: a library whose key
does not match is never loaded.  The libraries live in ``_build/`` next to
this file (listed in ``.gitignore``).  A failed build raises; nothing falls
back to the plain versions.  ``source_dir`` builds and binds another
version of ``csrc/`` instead, with the same C entry points, so that two
versions can be timed in one process; ``attributes`` reads a loaded
kernel's registers, local and shared memory.

Every C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; the launcher that ``bind`` returns raises
when that is not 0 and counts the launch in ``launches``, the only place a
kernel launch is counted.  ``launches`` counts launches the device
executes: a launch made while a CUDA graph is captured executes nothing, so
inside ``recording()`` it goes to the capture's record instead, and every
replay of the graph adds that record (``add_launches``, called by
``runtime.graphs``).
"""

from __future__ import annotations

import contextlib
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
    "mvplanes": ("mvplanes.cu", "vvc_mvplanes", "pppppp" + "iiiiii"),
    "cufold": ("cufold.cu", "vvc_cufold", "pppppppp" + "iiiiii"),
    **{f"probe_{p}": ("window_probe.cu", f"vvc_probe_{p}", "ppi")
       for p in ("k_a", "k_b", "k_c", "k_d_rows", "k_d_lanes", "k_e")},
    # an empty kernel of the probes' shape: the floor of a launch
    "empty_launch": ("window_probe.cu", "vvc_empty_launch", ""),
}

# launches of each kernel since the last reset_launches()
launches: Dict[str, int] = {name: 0 for name in _KERNELS}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # source path -> loaded library
build_log: Dict[str, str] = {}      # source path -> nvcc/ptxas output
_src_dir = _CSRC                    # where sources are read (source_dir)


# per thread: the launch record of the capture in progress, or None
_capture = threading.local()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def recording():
    """Inside the context, this thread's launches are not counted in
    ``launches`` but recorded in the dict it yields (kernel name ->
    launches): the launches that a CUDA graph's capture binds."""
    record: Dict[str, int] = {}
    outer = getattr(_capture, "record", None)
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = outer


def add_launches(record: Dict[str, int]) -> None:
    """Count the launches of ``record`` (one replay of a captured graph)."""
    for name, n in record.items():
        launches[name] += n


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return path


@contextlib.contextmanager
def source_dir(path: str):
    """Inside the context, build and bind kernels from the sources in
    ``path`` (another version of ``csrc/`` with the same C entry points)
    instead of this package's; their launches count as usual."""
    global _src_dir
    old, _src_dir = _src_dir, os.path.abspath(path)
    try:
        yield
    finally:
        _src_dir = old


def _so_path(src: str) -> str:
    with open(os.path.join(_src_dir, src), "rb") as f:
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
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_src_dir, src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, so, tmp, p in procs:
            out, _ = p.communicate(timeout=600)
            build_log[os.path.join(_src_dir, src)] = out
            if p.returncode != 0:
                failed.append(f"{src}:\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _library(src: str) -> ctypes.CDLL:
    key = os.path.join(_src_dir, src)
    with _lock:
        lib = _libs.get(key)
    if lib is None:
        build((src,))
        with _lock:
            lib = _libs.setdefault(key, ctypes.CDLL(_so_path(src)))
    return lib


def _function(name: str):
    src, sym, kinds = _KERNELS[name]
    fn = getattr(_library(src), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                   for k in kinds] + [ctypes.c_void_p]
    return fn


def attributes(name: str) -> Dict[str, int]:
    """Kernel ``name`` as loaded (``cudaFuncGetAttributes``, through its
    source's ``<entry>_attributes`` function, which K1, K2, the
    motion-plane kernel and the CU fold have): registers per thread, local
    memory per thread in bytes (the stack that spills use; 0 means none)
    and static shared memory per block."""
    src, sym, _ = _KERNELS[name]
    fn = getattr(_library(src), sym + "_attributes")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    vals = (ctypes.c_int * 3)()
    rc = fn(ctypes.cast(vals, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"kernel {name}: cudaFuncGetAttributes failed: "
                           f"CUDA error {rc}")
    return {"regs": vals[0], "spill_bytes": vals[1], "smem_bytes": vals[2]}


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


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary (the kernels'
    16-byte loads need it)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data not 16-byte aligned")


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
        record = getattr(_capture, "record", None)
        if record is None:
            launches[name] += 1
        else:
            record[name] = record.get(name, 0) + 1

    return run
