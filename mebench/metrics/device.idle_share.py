"""device.idle_share: the share, in %, of a frame-ref's wall time in
which no kernel, copy or set ran on a card, the mean over the cell's
cards: busy seconds per profiled frame-ref over the mean wall time of the
run's frame-refs that ran before the profiler started and without
``Timing`` (``trace.idle_shares``)."""

from mebench import trace


def read(rec):
    shares = trace.idle_shares(rec)
    return sum(shares) / len(shares) if shares else None
