"""k1_warp_roofline: K1's share of its roofline, in %: the least time of
its work over the profiled frame-refs at the published peaks
(``mebench.roofline``, counted from the algorithm, the whole frame over
all of the cell's cards) over the device time of ``warp_kernel`` in them.
Where the profiler dropped launches, its time is scaled to the launches
the program counted in the same frame-refs (``kernels.launches``), so the
share reads the same however the work is split into launches."""

from mebench import roofline, trace


def read(rec):
    p = rec["profile"]
    cfg = rec["config"]
    if p is None or cfg["engine"] != "plane" or not p["cards"]:
        return None
    n, s = trace.op_seconds(p, lambda name: "warp_kernel" in name)
    launched = p["launches"].get("warp", 0)
    if n == 0 or launched == 0:
        return None
    least = roofline.frame_ref(cfg["frame_w"], cfg["frame_h"],
                               extra_iters=cfg["extra_iters"])
    return 100 * least["k1_s"] * p["frame_refs"] / (s * launched / n)
