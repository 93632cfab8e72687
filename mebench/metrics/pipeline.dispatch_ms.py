"""pipeline.dispatch_ms: the pipeline's own CUDA-event seconds of the pair
(or stage) dispatches of a frame-ref (``runtime.reporting.Timing``), in
ms, the mean over the window's timed frame-refs outside the profile."""

from mebench import trace


def read(rec):
    w = trace.outside_profile(rec, True)
    return 1e3 * sum(f["dispatch_s"] for f in w) / len(w) if w else None
