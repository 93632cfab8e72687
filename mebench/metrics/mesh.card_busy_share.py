"""mesh.card_busy_share: in a CTU split, the share in % of the wall time
in which a card ran its graph: per card, the seconds between the CUDA
events around each of its replays (the port's ``graphs.replay.device``)
over the wall seconds of the same frame-refs (``trace.with_spans``), the
mean over the cards."""

from mebench import trace


def read(rec):
    w = trace.with_spans(rec)
    if rec["chips"] < 2 or not w:
        return None
    busy = {}
    for f in w:
        for card, d in f["spans"]["device"].items():
            busy[card] = busy.get(card, 0.0) + d["s"]
    if not busy:
        return None
    wall = sum(f["latency_s"] for f in w)
    return 100 * sum(busy.values()) / len(busy) / wall
