"""What the traced run reads from ``torch.profiler``: per card, the device
operations inside the profiled window, their union (busy time), and the
idle gaps between them, each charged to the ``record_function`` range
that the host was in when the gap began: the benchmark's own around its
calls, or one of the port's spans, which are ranges while the profiler
runs (``vvc_affine_tpu_torch.runtime.tracing``).

The events are read raw from the profiler's results (no event tree is
built: a 1080p frame-ref is some 66k device events).  The window is the
span between two marker ranges that the harness records when it starts and
stops profiling.  The summarising follows the port's
``tools/xprof_trace.py`` (device lanes of kernels, copies and sets; host
events never count), with plain durations in place of self times.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

START, END = "mebench.profile_start", "mebench.profile_end"


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(ranges: List[Tuple[int, int, str]]):
    """Piecewise-constant innermost range: (boundaries, labels) such that
    from boundaries[i] on, until the next, the host is in labels[i]."""
    cuts = sorted({t for a, b, _ in ranges for t in (a, b)})
    bounds, labels = [], []
    for t in cuts:
        active = [(a, name) for a, b, name in ranges if a <= t < b]
        bounds.append(t)
        labels.append(max(active)[1] if active else "encode.other")
    return bounds, labels


def summarize(events: Iterable, range_names: Iterable[str]) -> Dict:
    """Per-card device time by op name, busy and idle seconds, and idle
    seconds by harness range, inside the window marked by ``START`` and
    ``END``."""
    names = set(range_names)
    lanes: Dict[int, List[Tuple[int, int, str]]] = {}
    ranges: List[Tuple[int, int, str]] = []
    w0 = w1 = None
    for e in events:
        if _is_device(e):
            if e.is_user_annotation() or e.name() in names:
                continue        # a range's span on the device lane
            s = e.start_ns()
            lanes.setdefault(e.device_index(), []).append(
                (s, s + e.duration_ns(), e.name()))
            continue
        n = e.name()
        if n == START:
            w0 = e.start_ns()
        elif n == END:
            w1 = e.start_ns()
        elif n in names:
            s = e.start_ns()
            ranges.append((s, s + e.duration_ns(), n))
    if w0 is None or w1 is None or w1 <= w0:
        raise RuntimeError("the profile holds no window markers")
    bounds, labels = _innermost(ranges)
    cards = []
    idle_by_range: Dict[str, float] = {}
    for dev in sorted(lanes):
        ops: Dict[str, List[float]] = {}
        spans = []
        for s, e, n in lanes[dev]:
            if s < w0 or s >= w1:
                continue
            o = ops.setdefault(n, [0, 0.0])
            o[0] += 1
            o[1] += (e - s) / 1e9
            spans.append((s, min(e, w1)))
        busy = _merge(spans)
        busy_ns = sum(b - a for a, b in busy)
        t = w0
        for a, b in busy + [(w1, w1)]:
            if a > t:
                i = bisect.bisect_right(bounds, t) - 1
                label = labels[i] if i >= 0 else "encode.other"
                if t == w0 and label == "encode.other":
                    # the ranges open at the start began before the
                    # profile, which never saw them: the first gap goes to
                    # the first range entered after it
                    j = bisect.bisect_left(bounds, t)
                    label = labels[j] if j < len(labels) else label
                idle_by_range[label] = idle_by_range.get(label, 0.0) + (a - t) / 1e9
            t = max(t, b)
        cards.append({"device": dev, "busy_s": busy_ns / 1e9,
                      "idle_s": (w1 - w0 - busy_ns) / 1e9, "ops": ops})
    return {"window_s": (w1 - w0) / 1e9, "cards": cards,
            "idle_by_range": idle_by_range}


def op_seconds(profile: Dict, match=lambda name: True) -> Tuple[int, float]:
    """Launches and device seconds of the ops whose name ``match``es,
    over all cards."""
    n, s = 0, 0.0
    for card in profile["cards"]:
        for name, (k, sec) in card["ops"].items():
            if match(name):
                n += k
                s += sec
    return n, s


def outside_profile(rec: Dict, timed: bool) -> List[Dict]:
    """The window's frame-refs that ran before the profiler started (its
    first start initialises CUPTI, which slows every launch from then on),
    with the port's ``Timing`` (``timed``) or without it."""
    return [f for f in rec["window"] if not f["profiled"]
            and not f["after_profile"] and f["timed"] == timed]


def with_spans(rec: Dict) -> List[Dict]:
    """The frame-refs of ``outside_profile(rec, False)`` that carry the
    port's spans and counters (``spans``: what the recorder drained at
    their completion)."""
    return [f for f in outside_profile(rec, False) if "spans" in f]


def put_ms(rec: Dict):
    """The mean host ms of the port's ``pipeline.put`` spans (checking,
    pinning and copying a frame to each card) of a frame-ref that staged
    a frame (reference index 0), over ``with_spans``."""
    put = [f["spans"]["spans"].get("pipeline.put") for f in with_spans(rec)
           if f["key"][2] == 0]
    put = [p["host_s"] for p in put if p]
    return 1e3 * sum(put) / len(put) if put else None


def outside_dispatch_ms(rec: Dict):
    """The mean wall time of a timed frame-ref (from the completion of the
    one before to its own) less its dispatches' CUDA-event time, in ms."""
    w = outside_profile(rec, True)
    if not w:
        return None
    return 1e3 * sum(f["latency_s"] - f["dispatch_s"] for f in w) / len(w)


def idle_shares(rec: Dict):
    """Per card, the share in % of a frame-ref's wall time in which the
    card ran nothing: its busy seconds per profiled frame-ref (the
    profiler's kernels, copies and sets) over the mean wall seconds of the
    same run's frame-refs before the profile and without ``Timing``.  So
    the profiler's own slowing of the frame-refs it records and of every
    launch after its start, and ``Timing``'s synchronisation after every
    dispatch, stay out of it."""
    p = rec["profile"]
    w = outside_profile(rec, False)
    if p is None or not p["cards"] or not w:
        return None
    wall = sum(f["latency_s"] for f in w) / len(w)
    return [100 * (1 - c["busy_s"] / p["frame_refs"] / wall) for c in p["cards"]]


def breakdown(profile: Dict, top: int = 10) -> Dict:
    """The driver's ``breakdown``: the device ops that took most time (all
    cards) and the idle seconds by what the host was doing."""
    total: Dict[str, float] = {}
    for card in profile["cards"]:
        for name, (_, sec) in card["ops"].items():
            total[name] = total.get(name, 0.0) + sec
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(profile["idle_by_range"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
