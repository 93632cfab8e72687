"""The port's spans and counters: off by default, on inside ``record()``.

    from vvc_affine_tpu_torch.runtime import tracing

    with tracing.record() as rec:
        pipe.encode(orig, recon, on_result)   # on_result may call rec.drain()
        agg = rec.drain()

Sites in the port open spans where the work happens (``span``): the
pipeline's frame staging, lambda and dispatches (``models/pipeline.py``),
a graph's copy-in, replay, clone-out and capture (``runtime/graphs.py``)
and the split's input moves, per-card issue, join and per-card pin
(``parallel/mesh.py``).  A span is a host interval on
``time.perf_counter_ns()`` with its name, its parent (the span open around
it) and the attributes its site gives (``poc``, ``ref_idx``, ``mode``,
``n_cp``, ``card``; ``nbytes`` on ``pipeline.put``).  While a
``torch.profiler`` session is active, each span is also a
``record_function`` range of the same name, so the port's spans share the
profiler's clock with the device's events.

Counters: ``graphs.nodes`` (a graph's nodes by type, read from the captured
graph at its first replay under a recorder: once per graph and process),
``graphs.nodes_replayed`` (each replay adds its graph's nodes),
``graphs.replays`` and ``pipeline.bytes_staged`` (host-to-card bytes of the
frames, per card).  Each replay is also bracketed by two CUDA events on
its stream, taken from a pool and reused once they have completed: the
device span ``graphs.replay.device`` of that card.

When no recorder is active, a span site costs one check of the module's
``active`` (a site that must compute an attribute tests it itself): no
clock is read, no event recorded, nothing allocated.  The launch count
stays ``kernels.launches``, and a graph's capture time
``Graphed.capture_s`` is the ``graphs.capture`` span's own measurement.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

# the recorder in use, or None: the one value every span site checks
active: Optional["Recorder"] = None


class _Null:
    """The span of a site while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Span:
    """One host span of a recorder; its own context while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "_rec",
                 "_range")

    def __init__(self, rec, name, attrs):
        self._rec = rec
        self.name = name
        self.parent = rec._stack[-1] if rec._stack else None
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self):
        return f"Span({self.name!r}, {self.seconds:.6f} s, {self.attrs})"

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._rec._stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._rec._stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._rec.spans.append(self)
        return False


def _attrs(poc, ref_idx, mode, n_cp, card) -> Dict:
    return {k: v for k, v in (("poc", poc), ("ref_idx", ref_idx),
                              ("mode", mode), ("n_cp", n_cp),
                              ("card", None if card is None else _card(card)))
            if v is not None}


def _card(device) -> str:
    return str(device)


class Recorder:
    """What ``record()`` yields.  ``spans`` holds the spans closed since
    the last ``drain()``; ``counters`` the counts since then."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict = {}
        self._stack: List[Span] = []
        # per card: replays whose events are not yet resolved, and the
        # free event pairs
        self._pending: List = []
        self._pool: Dict[str, List] = {}

    def count(self, name, n, card=None) -> None:
        if card is None:
            self.counters[name] = self.counters.get(name, 0) + n
        else:
            per = self.counters.setdefault(name, {})
            per[card] = per.get(card, 0) + n

    def replay_events(self, device):
        """A (start, end) pair of timing events for one replay on
        ``device``, from its pool; resolved by a later ``drain``."""
        card = _card(device)
        free = self._pool.setdefault(card, [])
        if free:
            pair = free.pop()
        else:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        self._pending.append((card, pair))
        return pair

    def drain(self) -> Dict:
        """The aggregate of everything closed since the last drain, which
        it forgets: ``spans`` {name: {"count", "host_s"}}, ``device``
        {card: {"replays", "s"}} of the replays whose end event has
        completed (the others stay for the next drain; nothing waits) and
        ``counters``."""
        spans: Dict[str, Dict] = {}
        for sp in self.spans:
            agg = spans.setdefault(sp.name, {"count": 0, "host_s": 0.0})
            agg["count"] += 1
            agg["host_s"] += sp.seconds
        device: Dict[str, Dict] = {}
        pending = []
        for card, (start, end) in self._pending:
            if not end.query():
                pending.append((card, (start, end)))
                continue
            d = device.setdefault(card, {"replays": 0, "s": 0.0})
            d["replays"] += 1
            d["s"] += start.elapsed_time(end) / 1e3
            self._pool[card].append((start, end))
        self._pending = pending
        out = {"spans": spans, "device": device, "counters": self.counters}
        self.spans, self.counters = [], {}
        return out

    @property
    def unresolved(self) -> int:
        """Replays whose device events a drain has not yet resolved."""
        return len(self._pending)


@contextlib.contextmanager
def record():
    """Record the port's spans and counters inside the context (one
    recorder at a time)."""
    global active
    if active is not None:
        raise RuntimeError("a tracing recorder is already active")
    rec = Recorder()
    active = rec
    try:
        yield rec
    finally:
        active = None


def span(name, *, poc=None, ref_idx=None, mode=None, n_cp=None, card=None):
    """The context of one span named ``name`` (a no-op while nothing
    records)."""
    rec = active
    if rec is None:
        return _NULL
    return Span(rec, name, _attrs(poc, ref_idx, mode, n_cp, card))


def closed(name, start_ns, end_ns, *, card=None) -> None:
    """A span the caller timed itself (``graphs.capture``), nested in the
    open one."""
    rec = active
    if rec is not None:
        sp = Span(rec, name, _attrs(None, None, None, None, card))
        sp.start_ns, sp.end_ns = start_ns, end_ns
        rec.spans.append(sp)


def count(name, n, card=None) -> None:
    """Add ``n`` to counter ``name`` (per card when one is given)."""
    rec = active
    if rec is not None:
        rec.count(name, n, None if card is None else _card(card))


def graph_nodes(card, nodes: Dict[str, int]) -> None:
    """Note one graph's nodes by type (``graphs.nodes``), counted at its
    first replay under a recorder."""
    rec = active
    if rec is not None:
        rec.counters.setdefault("graphs.nodes", []).append(
            {"card": _card(card), **nodes})
