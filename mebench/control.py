"""The control of a cell's check: the plain reference with its solver in
float32, the precision below the float64 that the configuration states,
put in the program's place and driven through the harness's own window
and check (``run.run_cell``), which has to come out not correct.

    python3 mebench/control.py --workload <cell> --seeds 11,12,13 [--seconds 45]

The window is short: the reference is slower than the program, and the
window only has to reach as many frame-refs as a run checks (the mix's
``check``: with fewer than four references and with four).  One JSON line
per seed with the run's ``correct`` and checks, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from mebench import run  # noqa: E402


def float32_reference(pipe):
    """Hook of ``run.run_cell``: every pair or stage of the pipeline is
    replaced by the reference with a float32 solver, fed the same staged
    frames and lambda."""
    import torch
    from mebench import reference
    if pipe.cfg.mesh is not None:
        raise ValueError("the control runs on one card (a split's control "
                         "is its one-card configuration's)")
    fw, fh = pipe.cfg.frame_w, pipe.cfg.frame_h

    def stage(mode, n_cp, ref, orig, lam, prev):
        return reference.stage(mode, n_cp, ref, orig, fw, fh, float(lam),
                               prev=prev if n_cp == 3 else None,
                               solver_dtype=torch.float32,
                               extra_iters=pipe.cfg.extra_iters)

    for mode in list(pipe.pairs):
        def pair(ref, orig, lam, prev, _mode=mode):
            c2, p2 = stage(_mode, 2, ref, orig, lam, None)
            return (c2, p2) + stage(_mode, 3, ref, orig, lam, p2)
        pipe.pairs[mode] = pair
    for mode, n_cp in list(pipe.stages):
        pipe.stages[(mode, n_cp)] = (
            lambda ref, orig, lam, prev, _m=mode, _n=n_cp:
            stage(_m, _n, ref, orig, lam, prev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    run._cache_dirs()
    outs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           hook=float32_reference)
        outs.append(out)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "checks": out["checks"],
                          "seconds": time.time() - t0}), flush=True)
    # the control fails by its decisions, not by a window too short to check
    sound = all(o["checks"]["frame_refs_not_checked"]["value"] == 0 for o in outs)
    print(json.dumps({
        "workload": args.workload, "every_sample_checked": sound,
        "control_correct_on_no_seed": not any(o["correct"] for o in outs),
        "differing_decisions": [o["checks"]["differing_decisions"]["value"]
                                for o in outs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
