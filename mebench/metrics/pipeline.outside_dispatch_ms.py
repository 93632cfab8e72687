"""pipeline.outside_dispatch_ms: the wall time of a frame-ref (from the
completion of the one before to its own) less its dispatches' CUDA-event
time, in ms: frame staging, lambda, the readback and the callback.  The
mean over the same frame-refs as ``pipeline.dispatch_ms``."""

from mebench import trace


def read(rec):
    return trace.outside_dispatch_ms(rec)
