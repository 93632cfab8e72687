"""Run a command while sampling its card's power and memory with nvidia-smi.

Counterpart of the JAX repository's ``tools/power_trace.py``, with the
reference's own measurement (powerTracer_Affine_NVIDIA.py:8-56): beside the
command, ``nvidia-smi --query-gpu=timestamp,memory.used,<power> -lms P``
samples the card the command runs on (``--DeviceIndex``, CUDA's numbering,
matched to ``nvidia-smi``'s by UUID), where the TPU tool could read only
its own process's allocator.  ``<power>`` is ``power.draw.instant`` where
``nvidia-smi --help-query-gpu`` lists it, else ``power.draw`` (on recent
drivers a one-second average).  The command's standard output is joined
with the trace through its ``START``/``FINISHED`` stamps
(``tools.energy_report``):

    python -m vvc_affine_tpu_torch.tools.power_trace --out trace.csv -- \\
        python -m vvc_affine_tpu_torch.cli -f 2 -s 1920x1080 -q 32 \\
        -o O.csv -r R.csv | tee run.log

The trace keeps the JAX tool's layout, so its analyzer parses it too:
``t_epoch, bytes_in_use, peak_bytes_in_use, power_w`` rows (bytes from
``memory.used``, every process's on the card; the sample's own time from
``nvidia-smi``), a ``power_field,<field>`` row (it starts with a letter,
so the JAX parser skips it), a blank row, then ``marker, t_epoch`` rows of
the command's stamps.  Without ``--out`` the trace goes to a new temporary
file.  The tool exits with the command's code; when ``nvidia-smi`` fails
it raises.  ``main(argv, device="cpu")`` runs the command without a card
and samples the host clock only (zero bytes, no power), as the CLI's
``--DeviceTrace`` does on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import re
import subprocess
import sys
import threading
import time

from vvc_affine_tpu_torch import resolve_device
from vvc_affine_tpu_torch.tools import common

HEADER = ("t_epoch", "bytes_in_use", "peak_bytes_in_use", "power_w")
# the command's "<MARKER>,<epoch>," stamps (runtime.reporting.Timing.stamp)
_MARK = re.compile(r"^([A-Z][A-Za-z0-9 ._+-]*),(\d+\.\d+),$", re.M)


def power_field() -> str:
    """The instantaneous power field where this driver has it."""
    help_text = common.smi("--help-query-gpu")
    return ("power.draw.instant" if '"power.draw.instant"' in help_text
            else "power.draw")


def _epoch(stamp: str) -> float:
    """``nvidia-smi``'s timestamp (local time, to the millisecond) as
    seconds since the epoch, the clock of the command's stamps."""
    return datetime.datetime.strptime(
        stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


def _power(text: str):
    """Watts, or None where the card reports none ("[N/A]")."""
    try:
        return float(text)
    except ValueError:
        return None


class SmiSampler:
    """``nvidia-smi -lms`` on one card, read line by line in a thread into
    ``rows`` of (t_epoch, bytes_in_use, peak_bytes_in_use, power_w)."""

    def __init__(self, index: str, field: str, period_ms: int):
        self.field = field
        self.rows: list = []
        self.error = None
        self._proc = subprocess.Popen(
            ["nvidia-smi", "-i", index,
             f"--query-gpu=timestamp,memory.used,{field}",
             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._th = threading.Thread(target=self._read, daemon=True)
        self._th.start()

    def _read(self) -> None:
        peak = 0
        line = ""
        try:
            for line in self._proc.stdout:
                ts, mem, pw = (f.strip() for f in line.split(","))
                used = int(float(mem) * 2**20)
                peak = max(peak, used)
                self.rows.append((_epoch(ts), used, peak, _power(pw)))
        except ValueError as e:     # a line of another shape
            self.error = f"unreadable sample {line!r}: {e}"

    def stop(self) -> None:
        """Stop sampling; raises when ``nvidia-smi`` had stopped on its
        own (a refused query) or gave no sample.  The reader thread reads
        to the end of the output before the pipes are closed."""
        died = self._proc.poll() is not None
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._th.join()
        err = self._proc.stderr.read()
        self._proc.stdout.close()
        self._proc.stderr.close()
        if died or self.error or not self.rows:
            raise RuntimeError(f"nvidia-smi gave {len(self.rows)} samples "
                               f"(exit {self._proc.returncode}): "
                               f"{self.error or err}")


class ClockSampler:
    """The host clock alone, for a command on the CPU: zero bytes, no
    power."""

    field = None

    def __init__(self, period_ms: int):
        self.rows: list = []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, args=(period_ms,),
                                    daemon=True)
        self._th.start()

    def _run(self, period_ms: int) -> None:
        while not self._stop.is_set():
            self.rows.append((time.time(), 0, 0, None))
            time.sleep(period_ms / 1e3)

    def stop(self) -> None:
        self._stop.set()
        self._th.join(timeout=10)


def write_trace(path: str, rows, field, stdout: str) -> None:
    """The trace file: samples, the power field, a blank row, markers."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        if field is not None:
            w.writerow(["power_field", field])
        for t, used, peak, pw in rows:
            w.writerow([f"{t:.6f}", used, peak, "" if pw is None else pw])
        w.writerow([])
        w.writerow(["marker", "t_epoch"])
        w.writerows(_MARK.findall(stdout))


def main(argv=None, device=None) -> int:
    """Run the command and write its trace; returns the command's exit
    code.  ``device`` overrides ``cuda:<DeviceIndex>``."""
    ap = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.power_trace",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--out", default="",
                    help="trace CSV (default: a new temporary file)")
    ap.add_argument("--period-ms", type=int, default=1,
                    help="nvidia-smi's sampling period in ms (-lms)")
    ap.add_argument("--DeviceIndex", type=int, default=0,
                    help="the CUDA index of the card the command runs on")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- the command and its arguments")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd or cmd[0].startswith("-"):
        ap.error("give the command after --")
    if args.period_ms < 1:
        ap.error("--period-ms must be at least 1")
    dev = resolve_device(f"cuda:{args.DeviceIndex}" if device is None
                         else device)
    out = args.out or common.temp_path("power_trace_", ".csv")

    if dev.type == "cuda":
        sampler = SmiSampler(common.card_index(dev), power_field(),
                             args.period_ms)
    else:
        sampler = ClockSampler(args.period_ms)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        sampler.stop()
    t1 = time.time()
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    write_trace(out, sampler.rows, sampler.field, proc.stdout)
    print(f"trace: {len(sampler.rows)} samples over {t1 - t0:.3f}s "
          f"(power: {sampler.field or 'none'}) -> {out}")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
