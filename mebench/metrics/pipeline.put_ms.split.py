"""pipeline.put_ms.split: ``pipeline.put_ms`` in a CTU split, where each
frame is pinned and copied once per card (``mesh.replicate``)."""

from mebench import trace


def read(rec):
    if rec["chips"] < 2:
        return None
    return trace.put_ms(rec)
