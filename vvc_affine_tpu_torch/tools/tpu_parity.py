"""The four-stage chain on the card, bit for bit against a CPU golden.

Counterpart of the JAX repository's ``tools/tpu_parity.py`` (the name is
kept so the counterpart is found; this tool compares the card with the
CPU).  It runs FULL_2CP -> FULL_3CP and HALF_2CP -> HALF_3CP of the plane
engine on the JAX tool's synthetic pair (smooth content moved by (+2, -2)
samples, with a noise bit) twice:

* the CPU golden in a child process (``device="cpu"``: the plain versions
  of the kernels), with as many intra-op threads as this process, saved to
  an ``.npz`` in a temporary directory;
* the card run in this process (the hand-written kernels), while the child
  works;

then compares every stage's costs and CPMVs bit for bit, prints the JSON
report (the JAX report's ``resolution``, ``backend``, ``stages`` and
``ok``, and ``device``: the card's name and power limit) and writes it to
``--out`` when given.  It exits 1 on a mismatch; a failed child raises.

    python -m vvc_affine_tpu_torch.tools.tpu_parity [WxH] [--out FILE]

The JAX tool's ``--mxu``, ``--i16taps``, ``--f32`` and ``--rebase`` are TPU
knobs; argparse refuses them.  ``main(argv, device="cpu")`` runs the
"card" side on the CPU too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_plane as ap
from vvc_affine_tpu_torch.tools import common

STAGES = (("full", 2), ("full", 3), ("half", 2), ("half", 3))
LAMBDA = 78.949063

# the CPU golden: run_chain on the CPU, saved to an .npz
_CHILD = """
import sys
import numpy as np
import torch
from vvc_affine_tpu_torch.tools import tpu_parity
fw, fh, threads, npz = int(sys.argv[1]), int(sys.argv[2]), \\
    int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(threads)
np.savez(npz, **tpu_parity.run_chain(fw, fh, "cpu"))
"""


def frames(fw: int, fh: int, seed: int = 0):
    """The JAX tool's pair: smooth content shifted (+2, -2) samples, the
    original with a random low bit flipped; int32 [fh*fw] each."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 1024, size=(fh + 16, fw + 16)).astype(np.float64)
    for ax in (0, 1):
        big = (np.roll(big, 1, ax) + 2 * big + np.roll(big, -1, ax)) / 4
    ref = big[8:8 + fh, 8:8 + fw]
    orig = big[10:10 + fh, 6:6 + fw]

    def q(x):
        return np.clip(np.rint(x), 0, 1023).astype(np.int32).ravel()

    return q(ref), q(orig) ^ rng.integers(0, 2, size=fh * fw, dtype=np.int32)


def run_chain(fw: int, fh: int, device) -> dict:
    """Every stage's ``<mode>_<ncp>_cost`` and ``_cpmvs`` (numpy) on
    ``device``, 3CP from the mode's 2CP CPMVs."""
    dev = resolve_device(device)
    ref_np, orig_np = frames(fw, fh)
    out, prev = {}, {}
    for mode, n_cp in STAGES:
        spec = ap.PlaneSpec(mode, n_cp, fw, fh)
        pv = prev[mode] if n_cp == 3 else ap.zero_cpmvs(spec, "cpu")
        ref, orig, lam, pv = ap.stage_inputs_from_numpy(
            ref_np, orig_np, LAMBDA, np.asarray(pv), dev)
        t0 = time.time()
        cost, cp = (x.cpu().numpy() for x in ap.build_stage(spec, dev)(
            ref, orig, lam, pv))
        print(f"  {mode}_{n_cp}cp on {dev}: {time.time() - t0:.2f}s",
              flush=True)
        out[f"{mode}_{n_cp}_cost"] = cost
        out[f"{mode}_{n_cp}_cpmvs"] = cp
        if n_cp == 2:
            prev[mode] = cp
    return out


def main(argv=None, device=None) -> int:
    """0 when every stage is bit-identical, else 1; ``device`` overrides
    ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.tpu_parity",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    parser.add_argument("resolution", nargs="?", default=(416, 240),
                        type=common.frame_size, help="WxH (416x240)")
    parser.add_argument("--out", default="", help="JSON report file")
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    fw, fh = args.resolution
    print(f"parity run {fw}x{fh}: {dev} against a CPU golden", flush=True)
    with tempfile.TemporaryDirectory(prefix="tpu_parity_") as tmp:
        npz = os.path.join(tmp, "golden.npz")
        child = common.python_child(_CHILD, str(fw), str(fh),
                                    str(torch.get_num_threads()), npz)
        try:
            got = run_chain(fw, fh, dev)
            rc = child.wait()
        finally:
            child.kill()
            child.wait()
        if rc != 0:
            raise subprocess.CalledProcessError(rc, "the CPU golden child")
        with np.load(npz) as z:
            golden = dict(z)

    report = {"resolution": f"{fw}x{fh}", "backend": dev.type,
              "device": common.card_line(dev), "stages": {}, "ok": True}
    for k in sorted(golden):
        match = bool(golden[k].dtype == got[k].dtype
                     and np.array_equal(golden[k], got[k]))
        report["stages"][k] = "bit-identical" if match else "MISMATCH"
        report["ok"] &= match
        if not match:
            d = np.flatnonzero(golden[k] != got[k])
            print(f"  {k}: {d.size} mismatches, first at flat {d[:5]}")
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"tpu_parity": report}), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
