"""graphs.nodes_per_frame_ref: the CUDA-graph nodes replayed per
frame-ref, summed over the cell's cards: the port's
``graphs.nodes_replayed`` counter (each replay adds its graph's nodes)
over the frame-refs of ``trace.with_spans``.  A count: it repeats exactly
while the graphs stay the same."""

from mebench import trace


def read(rec):
    n = [f["spans"]["counters"].get("graphs.nodes_replayed")
         for f in trace.with_spans(rec)]
    if not n or None in n:
        return None
    return sum(n) / len(n)
