"""Card power beside a run: ``nvidia-smi`` sampling into a file.

The logic of the port's ``tools/power_trace.py`` (itself the reference's
powerTracer_Affine_NVIDIA.py), kept here so that the benchmark imports no
measurement code of the program: ``nvidia-smi -lms P`` samples the run's
cards, matched to CUDA's numbering by UUID, reading
``power.draw.instant`` where the driver lists it (else ``power.draw``).
Samples go to a file under ``TMPDIR`` and are read once the window has
closed, so nothing runs in the benchmark's process while it measures.
"""

from __future__ import annotations

import datetime
import os
import statistics
import subprocess
import tempfile
from typing import Dict, List, Tuple

import torch


def smi(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True,
                          text=True, timeout=60, check=True).stdout


def _uuid(u) -> str:
    u = str(u).strip().lower()
    return u[4:] if u.startswith("gpu-") else u


def card_indices(devices) -> List[str]:
    """``nvidia-smi``'s index of each CUDA device, by UUID."""
    by_uuid = {}
    for line in smi("--query-gpu=index,uuid", "--format=csv,noheader").splitlines():
        index, uuid = (f.strip() for f in line.split(","))
        by_uuid[_uuid(uuid)] = index
    out = []
    for d in devices:
        u = _uuid(torch.cuda.get_device_properties(d).uuid)
        if u not in by_uuid:
            raise RuntimeError(f"nvidia-smi lists no card with the UUID of {d}")
        out.append(by_uuid[u])
    return out


def power_field() -> str:
    return ("power.draw.instant"
            if '"power.draw.instant"' in smi("--help-query-gpu")
            else "power.draw")


def card_lines(indices) -> List[str]:
    """Name and power limit of each card, as nvidia-smi prints them."""
    return [smi("-i", i, "--query-gpu=name,power.limit",
                "--format=csv,noheader").strip() for i in indices]


def _epoch(stamp: str) -> float:
    return datetime.datetime.strptime(
        stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


class Sampler:
    """``nvidia-smi`` sampling each of the given cards every ``period_ms``,
    one process per card, into files under ``TMPDIR``; ``stop`` ends them
    and returns the samples per card index as (epoch seconds, watts, SM
    clock in MHz)."""

    def __init__(self, indices, period_ms: int = 20):
        self.indices = list(indices)
        self.field = power_field()
        self._procs = []
        for i in self.indices:
            fd, path = tempfile.mkstemp(prefix=f"mebench_power{i}_", suffix=".csv")
            out = os.fdopen(fd, "w")
            proc = subprocess.Popen(
                ["nvidia-smi", "-i", i, f"--query-gpu=timestamp,{self.field},clocks.sm",
                 "--format=csv,noheader,nounits", "-lms", str(period_ms)],
                stdout=out, stderr=subprocess.PIPE, text=True)
            self._procs.append((i, path, out, proc))

    def stop(self) -> Dict[str, List[Tuple[float, float, float]]]:
        samples: Dict[str, List[Tuple[float, float, float]]] = {}
        errors = []
        for i, path, out, proc in self._procs:
            died = proc.poll() is not None
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            err = proc.stderr.read()
            proc.stderr.close()
            out.close()
            rows = []
            with open(path) as f:
                for line in f:
                    parts = [p.strip() for p in line.split(",")]
                    try:
                        rows.append((_epoch(parts[0]), float(parts[1]),
                                     float(parts[2])))
                    except (ValueError, IndexError):
                        continue    # "[N/A]", or a line cut by the stop
            os.remove(path)
            samples[i] = rows
            if died or not rows:
                errors.append(f"card {i}: {len(rows)} samples "
                              f"(exit {proc.returncode}) {err}")
        if errors:
            raise RuntimeError("nvidia-smi: " + "; ".join(errors))
        return samples


def energy(samples, t0: float, t1: float):
    """Joules of one card over [t0, t1]: the trapezoid rule over its
    samples, each end taken at the power interpolated there (or the
    nearest sample's).  Returns (joules, samples inside, their median W,
    their median SM clock in MHz)."""
    pts = sorted(samples)

    def at(t):
        for (ta, pa, _), (tb, pb, _) in zip(pts, pts[1:]):
            if ta <= t <= tb:
                return pa if tb == ta else pa + (pb - pa) * (t - ta) / (tb - ta)
        return pts[0][1] if t < pts[0][0] else pts[-1][1]

    inner = [(t, p) for t, p, _ in pts if t0 < t < t1]
    curve = [(t0, at(t0))] + inner + [(t1, at(t1))]
    joules = sum((tb - ta) * (pa + pb) / 2
                 for (ta, pa), (tb, pb) in zip(curve, curve[1:]))
    clocks = [c for t, _, c in pts if t0 < t < t1]
    med = statistics.median(p for _, p in inner) if inner else float("nan")
    mhz = statistics.median(clocks) if clocks else float("nan")
    return joules, len(inner), med, mhz
