"""k2_blockreduce_roofline: K2's share of its roofline, in %, as
``k1_warp_roofline`` for ``blockreduce_kernel``: its refining and its
SATD-only work at the least of each."""

from mebench import roofline, trace


def read(rec):
    p = rec["profile"]
    cfg = rec["config"]
    if p is None or cfg["engine"] != "plane" or not p["cards"]:
        return None
    n, s = trace.op_seconds(p, lambda name: "blockreduce_kernel" in name)
    launched = p["launches"].get("blockreduce", 0)
    if n == 0 or launched == 0:
        return None
    least = roofline.frame_ref(cfg["frame_w"], cfg["frame_h"],
                               extra_iters=cfg["extra_iters"])
    return 100 * least["k2_s"] * p["frame_refs"] / (s * launched / n)
