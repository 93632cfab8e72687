"""pipeline.outside_dispatch_ms.split: ``pipeline.outside_dispatch_ms`` in
a CTU split, where it moves the rate (a split reports no p90): the
staging of every frame on each card, lambda, the readback of the joined
decisions and the callback, per timed frame-ref, in ms."""

from mebench import trace


def read(rec):
    if rec["chips"] < 2:
        return None
    return trace.outside_dispatch_ms(rec)
