"""gather.device_ms: device time per profiled frame-ref of every kernel
of the gather engine (plain PyTorch ops replayed in the stage graphs),
summed over the cell's cards.  Copies and sets are not kernels."""

from mebench import trace


def read(rec):
    p = rec["profile"]
    if p is None or rec["config"]["engine"] != "gather" or not p["cards"]:
        return None
    _, s = trace.op_seconds(p, lambda n: not n.startswith(("Memcpy", "Memset")))
    return 1e3 * s / p["frame_refs"]
