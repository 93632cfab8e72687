"""The CTU-axis split of a 2CP stage at 1, 2 and 4 shards, one JSON line each.

Counterpart of the JAX repository's ``tools/scaling_bench.py``: one frame
(a seeded uniform 10-bit pair, lambda 78.949063, zero CPMVs) through
``parallel.mesh.build_plane_stage_sharded`` over N shards, for each N of
``--chips``, timed as the minimum of 3 runs after a warm one (host clock
around the call and a synchronisation of every card):

    python -m vvc_affine_tpu_torch.tools.scaling_bench [WxH] \\
        [--chips 1,2,4] [--mode full|half]

Each line has the JAX tool's fields (``chips``, ``mode``, ``resolution``,
``sec_per_stage``, ``cus_per_sec``, ``baseline_chips``,
``speedup_vs_baseline``, ``efficiency``), ``devices`` (the card of each
shard: distinct cards where there are N, else card 0 repeated) and
``results_sha256``, a digest of the stage's costs and CPMVs.  Every N must
give the baseline's results; the tool exits 1 when one does not.  With
fewer cards than N the shards share one card, and the line records the
host-bound split (N shards issue N passes of the glue), not a scaling
target.  ``main(argv, device="cpu")`` runs every shard on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np
import torch

from vvc_affine_tpu_torch import geometry as G
from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_plane as ap
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.tools import common


def _chips(text: str):
    try:
        chips = [int(c) for c in text.split(",")]
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not a list like "
                                         "1,2,4") from None
    if not chips or min(chips) < 1:
        raise argparse.ArgumentTypeError(f"{text!r}: counts must be >= 1")
    return chips


def shard_devices(n: int, device: torch.device):
    """N shards' devices: on the CPU N times the CPU; on the card N
    distinct cards where there are N, else card ``device`` N times."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def timed(fn, devices, n: int = 3):
    """(min seconds of n runs after a warm one, the warm run's outputs)."""
    out = fn()
    common.sync(devices)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        common.sync(devices)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def digest(outs) -> str:
    """sha256 of the outputs' bytes, in order."""
    h = hashlib.sha256()
    for x in outs:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None, device=None) -> int:
    """One JSON line per shard count; 1 when a count's results differ from
    the baseline's.  ``device`` overrides ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.scaling_bench",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    parser.add_argument("resolution", nargs="?", default=(1920, 1080),
                        type=common.frame_size, help="WxH (1920x1080)")
    parser.add_argument("--chips", type=_chips, default=[1, 2, 4],
                        help="shard counts, comma-separated (1,2,4)")
    parser.add_argument("--mode", choices=("full", "half"), default="full")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    fw, fh = args.resolution
    chips = args.chips

    rng = np.random.default_rng(0)
    ref_np = rng.integers(0, 1024, (fh * fw,)).astype(np.int32)
    orig_np = rng.integers(0, 1024, (fh * fw,)).astype(np.int32)
    spec = ap.PlaneSpec(args.mode, 2, fw, fh)
    inputs = ap.stage_inputs_from_numpy(
        ref_np, orig_np, 78.949063, ap.zero_cpmvs(spec, "cpu"), dev)
    cus = G.frame_grid(fw, fh).num_ctus * G.layout(args.mode).cus_per_ctu

    t1 = want = None
    ok = True
    for n in chips:
        devices = shard_devices(n, dev)
        run = pmesh.build_plane_stage_sharded(spec, pmesh.make_mesh(devices))
        t, outs = timed(lambda: run(*inputs), devices)
        got = digest(outs)
        if t1 is None:
            t1, want = t, got
        ok &= got == want
        print(json.dumps({
            "chips": n, "mode": args.mode, "resolution": f"{fw}x{fh}",
            "sec_per_stage": t, "cus_per_sec": cus / t,
            # baseline = the first (smallest) count measured, 1 unless
            # --chips starts higher
            "baseline_chips": chips[0],
            "speedup_vs_baseline": t1 / t,
            "efficiency": t1 * chips[0] / (n * t),
            "devices": [str(d) for d in devices],
            "results_sha256": got,
        }), flush=True)
    if not ok:
        print("scaling_bench: a shard count's results differ from the "
              "baseline's", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
