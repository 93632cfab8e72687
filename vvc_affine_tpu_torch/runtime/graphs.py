"""A stage or a pair as one CUDA graph on the card, built once and replayed.

The port's counterpart of the JAX package's jitted stage builders
(``vvc_affine_tpu/models/affine_plane.py``, ``build_stage`` and
``build_pair_stage``; ``models/affine_me.py``, ``build_stage``;
``parallel/mesh.py``, ``build_stage_sharded``; all under ``jax.jit``).
Eagerly, a 1080p 2CP->3CP plane pair is some 22k (FULL) to 46k (HALF)
small device launches, a 2CP gather stage some 16k-22k, each issued by the
host at several times its device time.  ``Graphed`` wraps such an eager
callable for one CUDA device:

* its first call is the warm-up: ``fn`` runs eagerly on a side stream
  (which loads the lazily bound kernels and primes the caching allocator),
  and that result is returned.  Then ``fn`` is captured, on static copies of
  the same inputs, into one ``torch.cuda.CUDAGraph``;
* every later call copies its inputs into the static ones, replays the
  graph on the current stream (after whatever the caller queued there,
  such as the pipeline's asynchronous frame copies) and returns clones of
  the graph's outputs, which the caller owns: the next replay overwrites
  the graph's own;
* a capture that fails raises.  Nothing carries on eagerly on the card.

Every graph is captured with ``keep_graph=True`` and instantiated
explicitly, so that its nodes can be counted by type through the CUDA
driver (``count_nodes``) whenever a ``runtime.tracing`` recorder first
replays it, whether or not one was active at its capture.  While a
recorder is active, the copy-in, replay, clone-out and capture are spans
(``graphs.*``), and each replay is bracketed by the recorder's CUDA events
and adds the graph's nodes to ``graphs.nodes_replayed``.

So every call executes each kernel launch of ``fn`` once.  The launches
that the capture binds execute nothing: ``kernels.recording`` keeps them
out of ``kernels.launches``, and each replay adds them.

The graphs of one device share one memory pool and one side stream.  That
is safe because a call copies its inputs in, replays and clones the
outputs out on one stream before any other graph of the device replays:
one graph's scratch may then overlap another graph's outputs, which are
never read after their clone.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from vvc_affine_tpu_torch import kernels
from vvc_affine_tpu_torch.runtime import tracing

_lock = threading.Lock()
# device -> (memory pool handle, side stream) shared by its graphs
_per_device: Dict[torch.device, tuple] = {}
# CUgraphNodeType values counted by name; every other type is "other"
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def _pool_and_stream(device: torch.device):
    with _lock:
        if device not in _per_device:
            with torch.cuda.device(device):
                _per_device[device] = (torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream(device))
        return _per_device[device]


def count_nodes(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The nodes of a graph captured with ``keep_graph=True``, by type
    (``kernel``, ``memcpy``, ``memset``, ``other``) and in all
    (``total``), read through the CUDA driver.  Raises when a count cannot
    be read."""
    lib = ctypes.CDLL("libcuda.so.1")
    get_nodes, get_type = lib.cuGraphGetNodes, lib.cuGraphNodeGetType
    get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t))
    get_type.argtypes = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))
    get_nodes.restype = get_type.restype = ctypes.c_int    # CUresult

    def call(name, rc):
        if rc != 0:
            raise RuntimeError(f"{name} returned CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", get_nodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", get_nodes(raw, nodes, ctypes.byref(n)))
    counts = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    kind = ctypes.c_int()
    for node in nodes:
        call("cuGraphNodeGetType", get_type(node, ctypes.byref(kind)))
        counts[NODE_TYPES.get(kind.value, "other")] += 1
    counts["total"] = n.value
    return counts


class Graphed:
    """``fn(*tensors) -> tuple of tensors`` captured as one CUDA graph on
    ``device`` at its first call and replayed from its second (module
    docstring).  ``check(*args)``, when given, validates every call's
    inputs on the host before anything runs or is copied.

    ``capture_s`` is the host seconds the capture and instantiation took
    (the ``graphs.capture`` span; None before it), ``launches`` the kernel
    launches of one replay, ``replays`` the replays so far and ``nodes``
    the graph's nodes by type (``count_nodes``), counted at its first
    replay under a recorder (None before).
    """

    def __init__(self, fn: Callable, device: torch.device,
                 check: Optional[Callable] = None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.fn = fn
        self.device = device
        self.check = check
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.nodes: Optional[Dict[str, int]] = None
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._outputs: Tuple[torch.Tensor, ...] = ()

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.check is not None:
            self.check(*args)
        with torch.cuda.device(self.device):
            if self.graph is None:
                return self._warm_up_and_capture(args)
            return self._replay(args)

    def _warm_up_and_capture(self, args):
        pool, side = _pool_and_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = tuple(self.fn(*args))
        current.wait_stream(side)
        for t in out:
            t.record_stream(current)
        inputs = tuple(a.clone() for a in args)
        # kept, so that a recorder can count its nodes (count_nodes)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter_ns()
        with kernels.recording() as record, torch.cuda.graph(
                graph, pool=pool, stream=side,
                capture_error_mode="thread_local"):
            outputs = tuple(self.fn(*inputs))
        graph.instantiate()
        t1 = time.perf_counter_ns()
        self.capture_s = (t1 - t0) / 1e9
        tracing.closed("graphs.capture", t0, t1, card=self.device)
        self.graph, self.launches = graph, record
        self._inputs, self._outputs = inputs, outputs
        return out

    def _replay(self, args):
        if len(args) != len(self._inputs):
            raise ValueError(f"{len(args)} inputs, the graph takes "
                             f"{len(self._inputs)}")
        for i, (a, s) in enumerate(zip(args, self._inputs)):
            if (a.dtype, a.shape, a.device) != (s.dtype, s.shape, s.device):
                raise ValueError(
                    f"input {i}: expected {s.dtype} {tuple(s.shape)} on "
                    f"{s.device}, got {a.dtype} {tuple(a.shape)} on "
                    f"{a.device}")
        rec = tracing.active
        if rec is not None and self.nodes is None:
            self.nodes = count_nodes(self.graph)
            tracing.graph_nodes(self.device, self.nodes)
        with tracing.span("graphs.copy_in", card=self.device):
            for a, s in zip(args, self._inputs):
                s.copy_(a)
        if rec is not None:
            start, end = rec.replay_events(self.device)
            start.record()
        with tracing.span("graphs.replay", card=self.device):
            self.graph.replay()
        if rec is not None:
            end.record()
            rec.count("graphs.replays", 1)
            rec.count("graphs.nodes_replayed", self.nodes["total"])
        kernels.add_launches(self.launches)
        self.replays += 1
        with tracing.span("graphs.clone_out", card=self.device):
            return tuple(o.clone() for o in self._outputs)


def for_device(fn: Callable, device: torch.device,
               check: Optional[Callable] = None) -> Callable:
    """``fn`` as it runs on ``device``: a ``Graphed`` capture of it on a
    card; on the CPU ``fn`` itself, eagerly."""
    if device.type == "cpu":
        return fn
    return Graphed(fn, device, check)
