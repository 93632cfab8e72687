"""Command-line entry point, flag-compatible with the reference binary and
with ``python -m vvc_affine_tpu.cli``.

Behavioural spec: main.cpp:58-86 (boost::program_options) — the same flags
drive the same run shape:

    python -m vvc_affine_tpu_torch.cli -f 2 -s 1920x1080 -q 32 \
        -o original_frames.csv -r reconstructed_frames.csv -l decisions_log

Runs on ``cuda:<DeviceIndex>``; ``--Engine gather`` runs the merged-group
engine (``models/affine_me.py``) in place of the plane engine, with the same
decision logs.  The flags of the JAX package that this port does not
implement yet (``--NumChips > 1``, ``--Coordinator``) are refused with exit
code 1.
"""

from __future__ import annotations

import argparse
import sys

from vvc_affine_tpu_torch.models.pipeline import AffineMEPipeline, PipelineConfig
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.runtime import reporting
from vvc_affine_tpu_torch.runtime.checkpoint import CheckpointManager


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vvc_affine_tpu_torch",
        description="VVC Affine Motion Estimation engine (PyTorch/CUDA)",
    )
    p.add_argument("--DeviceIndex", type=int, default=0,
                   help="Index of the CUDA device (main.cpp:154-216)")
    p.add_argument("--NumChips", type=int, default=1,
                   help="Shard the CTU axis over this many devices "
                        "(not yet ported: 1 only)")
    p.add_argument("--Coordinator", type=str, default="",
                   help="host:port of a multi-host coordinator "
                        "(not yet ported)")
    p.add_argument("--NumProcesses", type=int, default=1,
                   help="Total process count of the multi-host run")
    p.add_argument("--ProcessId", type=int, default=0,
                   help="This process's rank in the multi-host run")
    p.add_argument("-q", "--QP", type=int, required=True,
                   help="Quantization parameter")
    p.add_argument("-f", "--FramesToBeEncoded", type=int, required=True,
                   help="Number of frames to be processed")
    p.add_argument("--ExtraGradientIter", type=int, default=0,
                   help="Extra iterations during gradient-based Affine ME")
    p.add_argument("-s", "--Resolution", type=str, required=True,
                   help="Resolution of the video, e.g. 1920x1080")
    p.add_argument("-o", "--OriginalFrames", type=str, required=True,
                   help="CSV of original frame samples")
    p.add_argument("-r", "--ReferenceFrames", type=str, required=True,
                   help="CSV of reference frame samples")
    p.add_argument("-l", "--CpmvLogFile", type=str, default="",
                   help="Decision-log file prefix (empty: no logs)")
    p.add_argument("--ReportToTerminal", action="store_true")
    p.add_argument("--CheckpointDir", type=str, default="",
                   help="enable GOP-level checkpoint/resume in this directory")
    p.add_argument("--MemoryReport", action="store_true",
                   help="print the device-buffer footprint table")
    p.add_argument("--DeviceTrace", type=str, default="",
                   help="write a ~1ms in-process device activity trace CSV "
                        "(join with tools/energy_report.py)")
    p.add_argument("--SkipFull", action="store_true",
                   help="Skip aligned-CU prediction")
    p.add_argument("--SkipHalf", action="store_true",
                   help="Skip half-aligned-CU prediction")
    p.add_argument("--Engine", choices=("plane", "gather"), default="plane",
                   help="Compute engine: 'plane' (dense planes, the CUDA "
                        "kernels) or 'gather' (per-CU window gathers in "
                        "plain PyTorch ops, four separate stages); the "
                        "decisions are identical")
    p.add_argument("--PerPredTiming", action="store_true",
                   help="Dispatch the 2CP/3CP stages separately for a "
                        "per-pred-type timing split (the reference's "
                        "kernelExecutionTime[4]); default times each "
                        "mode's 2CP->3CP pair")
    return p


def _unported(args) -> list:
    flags = []
    if args.NumChips > 1:
        flags.append("--NumChips > 1")
    if args.Coordinator:
        flags.append("--Coordinator")
    return flags


def main(argv=None, device=None) -> int:
    """Run the CLI.  ``device`` overrides ``cuda:<DeviceIndex>`` (the tests
    pass ``device="cpu"``)."""
    args = build_parser().parse_args(argv)
    for flag in _unported(args):
        print(f"{flag}: not yet ported (ROADMAP)", file=sys.stderr)
    if _unported(args):
        return 1
    try:
        w, h = (int(v) for v in args.Resolution.lower().split("x"))
    except ValueError:
        print(f"Bad resolution {args.Resolution!r}; expected WxH", file=sys.stderr)
        return 1
    n = args.FramesToBeEncoded
    if device is None:
        device = f"cuda:{args.DeviceIndex}"

    cfg = PipelineConfig(
        frame_w=w, frame_h=h, qp=args.QP, extra_iters=args.ExtraGradientIter,
        test_full=not args.SkipFull, test_half=not args.SkipHalf,
        device=device, fused=not args.PerPredTiming, engine=args.Engine,
    )
    pipe = AffineMEPipeline(cfg)

    timing = reporting.Timing()
    timing.stamp("START HOST")

    timing.stamp("START READ .csv")
    orig = frames_io.read_frames_csv(args.OriginalFrames, w, h, n)
    ref = frames_io.read_frames_csv(args.ReferenceFrames, w, h, n)
    timing.stamp("FINISHED READ .csv")

    prefix = args.CpmvLogFile or None
    ckpt = None
    if args.CheckpointDir:
        ckpt = CheckpointManager(args.CheckpointDir, prefix)
    # a resumed run keeps the logs of the frames it has done
    if prefix and (ckpt is None or ckpt.completed_poc() == 0):
        reporting.remove_old_traces(prefix)

    def on_result(r):
        if not (prefix or args.ReportToTerminal):
            return
        costs = r.costs.cpu().numpy()
        cpmvs = r.cpmvs.cpu().numpy()
        print(f"Reporting results POC={r.poc} refIdx={r.ref_idx} "
              f"PredType={r.pred}")
        reporting.report_results(
            prefix, r.pred, w, costs, cpmvs,
            r.poc, r.ref_idx, to_terminal=args.ReportToTerminal,
        )

    tracer = None
    if args.DeviceTrace:
        tracer = reporting.DeviceTraceSampler(args.DeviceTrace, pipe.device)
        tracer.start()
    try:
        pipe.encode(orig, ref, on_result=on_result, timing=timing,
                    checkpoint=ckpt)
    finally:
        if tracer is not None:
            tracer.stop()
    if args.MemoryReport:
        print(reporting.memory_report(w, h, pipe.device))
    timing.report(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
