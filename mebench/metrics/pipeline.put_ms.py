"""pipeline.put_ms: the host ms of the port's ``pipeline.put`` spans (check,
int32 copy, pin and copy of a frame to the card) in a frame-ref that
stages a frame (reference index 0), the mean over ``trace.with_spans``
(``trace.put_ms``); on one card."""

from mebench import trace


def read(rec):
    if rec["chips"] > 1:
        return None
    return trace.put_ms(rec)
