"""Frame-level encoding pipeline: the engine's host orchestration.

Behavioural spec: the frame loop of main.cpp:578-1010 — per frame:
POC/numRefs/lambda selection, reference-buffer update, then for each refIdx
the four stages FULL_2CP -> FULL_3CP (consuming the 2CP CPMVs) ->
HALF_2CP -> HALF_3CP, with results handed to the decision-log writer.

Frames live on the device as tensors handed out by POC label (no
device-to-device slot copies); the next original frame is staged while the
current one is encoded (cf. main.cpp:711-715).  Either engine runs the
stages (``PipelineConfig.engine``).  With a mesh (``PipelineConfig.mesh``)
the stages are split over its devices along the CTU axis
(``parallel.mesh``) and each frame is staged once on every distinct device.
With timing, each pair (or stage) dispatch is bracketed by CUDA events on
the card — the analogue of the reference's per-kernel event profiling
(main.cpp:862-866) — and its end event is waited on before the time is
read.  While a ``runtime.tracing`` recorder is active, the staging of each
frame (``pipeline.put``, with its ``pipeline.bytes_staged`` per card; its
pin on one card, ``pipeline.put.pin``), the lambda (``pipeline.lambda``)
and each dispatch (``pipeline.dispatch``) are spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.models import affine_me, affine_plane
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.runtime.frames import check_samples
from vvc_affine_tpu_torch.runtime import tracing
from vvc_affine_tpu_torch.runtime.refmanager import ReferenceBuffer

PRED_FULL_2CP, PRED_FULL_3CP, PRED_HALF_2CP, PRED_HALF_3CP = range(4)


@dataclass
class PipelineConfig:
    frame_w: int
    frame_h: int
    qp: int
    extra_iters: int = 0
    test_full: bool = True
    test_half: bool = True
    # None -> "cuda"; pass "cpu" to run the plain versions on the CPU
    device: Optional[object] = None
    # a parallel.mesh.Mesh: the stages run split over its devices along the
    # CTU axis (the device above is then unused); outputs are bit-identical
    mesh: Optional[object] = None
    # run each mode's 2CP->3CP chain as one pair dispatch (timed per pair);
    # False times each pred type on its own (the reference's
    # kernelExecutionTime[4] split, main_aux_functions.h:1416-1446).  Plane
    # engine only: the gather engine always runs four separate stages.
    fused: bool = True
    # 'plane' = the dense engine with the CUDA kernels (models.affine_plane);
    # 'gather' = the merged-group engine in plain PyTorch ops
    # (models.affine_me).  Outputs are bit-identical.
    engine: str = "plane"


@dataclass
class StageResult:
    poc: int
    ref_idx: int
    pred: int
    # in a run of several processes, each a parallel.mesh.ProcessBlock
    # (runtime.distributed.gather_to_host)
    costs: torch.Tensor   # int64 [nCtu, nCU]
    cpmvs: torch.Tensor   # int32 [nCtu, nCU, 3, 2]


class _Timer:
    """Times one dispatch, from before its first shard to after its last:
    CUDA events on every card it runs on (the longest span counts), the
    host clock on the CPU."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.cuda = self.devices[0].type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.events = [(torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                           for _ in self.devices]
            for (start, _), d in zip(self.events, self.devices):
                start.record(torch.cuda.current_stream(d))
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            for (_, end), d in zip(self.events, self.devices):
                end.record(torch.cuda.current_stream(d))
            for _, end in self.events:
                end.synchronize()
            self.seconds = max(start.elapsed_time(end)
                               for start, end in self.events) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0
        return False


class AffineMEPipeline:
    """Runs Affine ME over a GOP of frames."""

    PRED_LABEL = ("FULL_2CP", "FULL_3CP", "HALF_2CP", "HALF_3CP")

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        if cfg.mesh is not None:
            self.device = cfg.mesh.devices[0]
            self._devices = pmesh.distinct_devices(cfg.mesh)
        else:
            self.device = resolve_device(cfg.device)
            self._devices = (self.device,)
        self.stages = {}
        self.pairs = {}
        if cfg.engine not in ("plane", "gather"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        for mode, on in (("full", cfg.test_full), ("half", cfg.test_half)):
            if not on:
                continue
            if cfg.engine == "gather":
                for n_cp in (2, 3):
                    spec = affine_me.StageSpec(mode, n_cp, cfg.frame_w,
                                               cfg.frame_h, cfg.extra_iters)
                    self.stages[(mode, n_cp)] = (
                        pmesh.build_stage_sharded(spec, cfg.mesh)
                        if cfg.mesh is not None else
                        affine_me.build_stage(spec, device=self.device))
                continue
            specs = tuple(
                affine_plane.PlaneSpec(mode, n_cp, cfg.frame_w, cfg.frame_h,
                                       cfg.extra_iters)
                for n_cp in (2, 3))
            if cfg.fused:
                self.pairs[mode] = (
                    pmesh.build_plane_pair_sharded(*specs, cfg.mesh)
                    if cfg.mesh is not None else
                    affine_plane.build_pair_stage(*specs, device=self.device))
            else:
                for spec in specs:
                    self.stages[(mode, spec.n_cp)] = (
                        pmesh.build_plane_stage_sharded(spec, cfg.mesh)
                        if cfg.mesh is not None else
                        affine_plane.build_stage(spec, device=self.device))
        self._zeros = {
            mode: affine_plane.zero_cpmvs(
                affine_plane.PlaneSpec(mode, 2, cfg.frame_w, cfg.frame_h),
                device=self.device)
            for mode in ("full", "half")
        }

    def _run_stage(self, key, pred, poc, ref_idx, ref_dev, orig_dev, lam,
                   prev, timing):
        """One stage dispatch; with timing, bracketed by START/FINISHED EXEC
        stamps per (pred, refIdx, POC) as the reference prints them
        (main.cpp:764-955)."""
        fn = self.stages[key]
        with tracing.span("pipeline.dispatch", poc=poc, ref_idx=ref_idx,
                          mode=key[0], n_cp=key[1]):
            if timing is None:
                return fn(ref_dev, orig_dev, lam, prev)
            label = f"EXEC {self.PRED_LABEL[pred]} POC {poc} ref {ref_idx}"
            timing.stamp(f"START {label}")
            with _Timer(self._devices) as tm:
                out = fn(ref_dev, orig_dev, lam, prev)
            timing.stamp(f"FINISHED {label}")
            timing.add(pred, tm.seconds, label)
            return out

    def _run_pair(self, mode, base, poc, ref_idx, ref_dev, orig_dev, lam,
                  timing):
        """One 2CP->3CP pair dispatch (cfg.fused); with timing, the time is
        attributed to the pair."""
        fn = self.pairs[mode]
        prev = self._zeros[mode]
        with tracing.span("pipeline.dispatch", poc=poc, ref_idx=ref_idx,
                          mode=mode):
            if timing is None:
                return fn(ref_dev, orig_dev, lam, prev)
            lbl = (f"EXEC {self.PRED_LABEL[base]}+{self.PRED_LABEL[base + 1]} "
                   f"POC {poc} ref {ref_idx}")
            timing.stamp(f"START {lbl}")
            with _Timer(self._devices) as tm:
                out = fn(ref_dev, orig_dev, lam, prev)
            timing.stamp(f"FINISHED {lbl}")
            timing.add_pair(base, tm.seconds, lbl)
            return out

    def _put(self, frame: np.ndarray):
        """Stage a host frame on the device as int32 [fh*fw] (10-bit
        samples, ``check_samples``); on the card the copy is asynchronous
        from pinned memory.  With a mesh, once on each of its distinct
        devices (``parallel.mesh.replicate``)."""
        with tracing.span("pipeline.put") as sp:
            check_samples(frame, "frame")
            host = torch.from_numpy(
                np.ascontiguousarray(frame, np.int32).reshape(-1))
            if tracing.active is not None:
                sp.attrs["nbytes"] = host.nbytes
                for d in self._devices:
                    tracing.count("pipeline.bytes_staged", host.nbytes, d)
            if self.cfg.mesh is not None:
                return pmesh.replicate(host, self.cfg.mesh)
            if self.device.type == "cuda":
                with tracing.span("pipeline.put.pin", card=self.device):
                    return host.pin_memory().to(self.device,
                                                non_blocking=True)
            return host

    def encode(
        self,
        orig_frames: np.ndarray,   # [N, H, W] (POC 1..N)
        ref_frames: np.ndarray,    # [N, H, W] (reconstructed POC 0..N-1)
        on_result: Optional[Callable[[StageResult], None]] = None,
        timing=None,
        checkpoint=None,           # runtime.checkpoint.CheckpointManager
    ) -> List[StageResult]:
        cfg = self.cfg
        n_frames = orig_frames.shape[0]
        refbuf = ReferenceBuffer()
        frames_by_poc: Dict[int, torch.Tensor] = {}
        results: List[StageResult] = []

        done_poc = 0
        if checkpoint is not None:
            done_poc = checkpoint.completed_poc()
            checkpoint.prune_logs_after(done_poc)

        # stage the first original frame (prefetching happens per iteration)
        orig_dev = self._put(orig_frames[0])
        next_orig = None

        for curr in range(n_frames):
            poc = curr + 1
            num_refs = min(C.MAX_REFS, poc)
            with tracing.span("pipeline.lambda", poc=poc):
                lam = torch.tensor(np.float32(C.lambda_for(cfg.qp, poc)),
                                   dtype=torch.float32, device=self.device)
                if cfg.mesh is not None:
                    lam = pmesh.replicate(lam, cfg.mesh)

            # reference list update: recon frame (poc-1) enters slot 0
            frames_by_poc[poc - 1] = self._put(ref_frames[curr])
            refbuf.push(poc)
            ref_labels = refbuf.ref_list(poc)
            # drop frames no longer referenced (keeps device memory flat)
            live = set(ref_labels)
            frames_by_poc = {k: v for k, v in frames_by_poc.items()
                             if k in live}

            # prefetch of the next original frame (double buffering,
            # cf. main.cpp:711-715)
            if curr + 1 < n_frames:
                next_orig = self._put(orig_frames[curr + 1])

            if poc <= done_poc:
                # resumed run: frame already complete; only the reference
                # bookkeeping above was needed
                if next_orig is not None:
                    orig_dev, next_orig = next_orig, None
                continue

            for ref_idx in range(num_refs):
                ref_dev = frames_by_poc[ref_labels[ref_idx]]
                per_ref: List[StageResult] = []
                for mode, base in (("full", PRED_FULL_2CP),
                                   ("half", PRED_HALF_2CP)):
                    if mode in self.pairs:
                        cost2, cp2, cost3, cp3 = self._run_pair(
                            mode, base, poc, ref_idx, ref_dev, orig_dev,
                            lam, timing)
                    elif (mode, 2) in self.stages:
                        cost2, cp2 = self._run_stage(
                            (mode, 2), base, poc, ref_idx,
                            ref_dev, orig_dev, lam, self._zeros[mode], timing)
                        cost3, cp3 = self._run_stage(
                            (mode, 3), base + 1, poc, ref_idx,
                            ref_dev, orig_dev, lam, cp2, timing)
                    else:
                        continue
                    per_ref.append(StageResult(poc, ref_idx, base, cost2, cp2))
                    per_ref.append(
                        StageResult(poc, ref_idx, base + 1, cost3, cp3))
                for r in per_ref:
                    results.append(r)
                    if on_result is not None:
                        on_result(r)

            if checkpoint is not None:
                checkpoint.mark_frame_done(poc)
            if next_orig is not None:
                orig_dev, next_orig = next_orig, None
        return results
