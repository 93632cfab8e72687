"""Command-line entry point, flag-compatible with the reference binary and
with ``python -m vvc_affine_tpu.cli``.

Behavioural spec: main.cpp:58-86 (boost::program_options) — the same flags
drive the same run shape:

    python -m vvc_affine_tpu_torch.cli -f 2 -s 1920x1080 -q 32 \
        -o original_frames.csv -r reconstructed_frames.csv -l decisions_log

Runs on ``cuda:<DeviceIndex>``, and exits with code 1 when there is no
such card; ``--Engine gather`` runs the merged-group
engine (``models/affine_me.py``) in place of the plane engine, with the same
decision logs.  ``--NumChips N`` splits the CTU axis over N cards from
``--DeviceIndex`` on (``parallel/mesh.py``), and exits with code 1 when
there are fewer.  ``--Coordinator host:port --NumProcesses P --ProcessId
R`` runs one of P processes (``runtime/distributed.py``), each on its
``--NumChips`` cards, over one split; process 0 alone writes the logs:

    python -m vvc_affine_tpu_torch.cli ... \
        --Coordinator 127.0.0.1:29500 --NumProcesses 2 --ProcessId 0
"""

from __future__ import annotations

import argparse
import sys

import torch

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models.pipeline import AffineMEPipeline, PipelineConfig
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.runtime import distributed as dist
from vvc_affine_tpu_torch.runtime import frames as frames_io
from vvc_affine_tpu_torch.runtime import reporting
from vvc_affine_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                     FollowerCheckpoint)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vvc_affine_tpu_torch",
        description="VVC Affine Motion Estimation engine (PyTorch/CUDA)",
    )
    p.add_argument("--DeviceIndex", type=int, default=0,
                   help="Index of the CUDA device (main.cpp:154-216)")
    p.add_argument("--NumChips", type=int, default=1,
                   help="Shard the CTU axis over this many devices from "
                        "--DeviceIndex on (per process; 1 = one device)")
    p.add_argument("--Coordinator", type=str, default="",
                   help="host:port of process 0 of a run of several "
                        "processes (torch.distributed, gloo); one CLI "
                        "invocation per process")
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


def _mesh_devices(args, device):
    """The ``--NumChips`` devices of this process: ``device`` that many
    times when given, else the cards from ``--DeviceIndex`` on; None (after
    saying so) when there are too few cards."""
    if device is not None:
        return [resolve_device(device)] * args.NumChips
    have = torch.cuda.device_count()
    if args.DeviceIndex + args.NumChips > have:
        print(f"Need {args.NumChips} devices starting at index "
              f"{args.DeviceIndex}, have {have}", file=sys.stderr)
        return None
    return [resolve_device(f"cuda:{args.DeviceIndex + i}")
            for i in range(args.NumChips)]


def main(argv=None, device=None) -> int:
    """Run the CLI.  ``device`` overrides ``cuda:<DeviceIndex>`` (the tests
    pass ``device="cpu"``; with ``--NumChips N`` the split then runs N
    shards on it)."""
    args = build_parser().parse_args(argv)
    try:
        w, h = (int(v) for v in args.Resolution.lower().split("x"))
    except ValueError:
        print(f"Bad resolution {args.Resolution!r}; expected WxH", file=sys.stderr)
        return 1
    n = args.FramesToBeEncoded

    mesh = None
    primary = True
    if args.Coordinator or args.NumChips > 1:
        devices = _mesh_devices(args, device)
        if devices is None:
            return 1
        if args.Coordinator:
            dist.initialize(args.Coordinator, args.NumProcesses,
                            args.ProcessId)
            mesh = dist.global_mesh(devices)
            primary = dist.is_primary()
        else:
            mesh = pmesh.make_mesh(devices)
    elif device is None:
        have = torch.cuda.device_count()
        if torch.cuda.is_available() and not 0 <= args.DeviceIndex < have:
            print(f"DeviceIndex {args.DeviceIndex} out of range "
                  f"({have} devices)", file=sys.stderr)
            return 1
        device = f"cuda:{args.DeviceIndex}"

    cfg = PipelineConfig(
        frame_w=w, frame_h=h, qp=args.QP, extra_iters=args.ExtraGradientIter,
        test_full=not args.SkipFull, test_half=not args.SkipHalf,
        device=device, mesh=mesh, fused=not args.PerPredTiming,
        engine=args.Engine,
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
        if primary:
            ckpt = CheckpointManager(args.CheckpointDir, prefix)
        if args.Coordinator:
            # every process must skip the same completed frames: the
            # result gathers are collective
            done = dist.broadcast_scalar(
                ckpt.completed_poc() if primary else 0)
            if not primary:
                ckpt = FollowerCheckpoint(done)
    # a resumed run keeps the logs of the frames it has done
    if prefix and primary and (ckpt is None or ckpt.completed_poc() == 0):
        reporting.remove_old_traces(prefix)

    def on_result(r):
        if not (prefix or args.ReportToTerminal):
            return
        costs = dist.gather_to_host(r.costs)
        cpmvs = dist.gather_to_host(r.cpmvs)
        if not primary:   # process 0 owns the decision logs
            return
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
    if args.Coordinator:
        dist.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
