"""plane_glue.device_ms: device time per profiled frame-ref, summed over
the cell's cards, of every kernel of the plane engine but K1
(``warp_kernel``) and K2 (``blockreduce_kernel``): the stage loop's glue,
replayed inside the CUDA graphs.  Copies and sets are not kernels."""

from mebench import trace

HAND = ("warp_kernel", "blockreduce_kernel")


def read(rec):
    p = rec["profile"]
    if p is None or rec["config"]["engine"] != "plane" or not p["cards"]:
        return None
    _, s = trace.op_seconds(p, lambda n: not any(h in n for h in HAND)
                            and not n.startswith(("Memcpy", "Memset")))
    return 1e3 * s / p["frame_refs"]
