"""Join a power trace with a run's stamps into an activity and energy report.

Counterpart of the JAX repository's ``tools/energy_report.py`` and of the
reference's computeEnergy_Affine_NVIDIA_v2.py:80-195, which joins the
``print_timestamp`` markers of the run log with the 1 ms ``nvidia-smi``
power trace.  First it prints, line for line, what the JAX analyzer prints
for the trace's first three columns: per phase the seconds, the device duty
cycle (the share of the phase covered by the run's ``EXEC`` dispatch
windows, each closed by a device synchronisation) and the mean bytes in use.
Then, where the trace has power (``tools.power_trace`` on a card), one more
block: per phase the mean power in W, the energy in J (mean W times the
phase's seconds) and the count of distinct power readings inside it, and a
``TOTAL_EXEC`` line over the ``EXEC`` windows with the joules per frame-ref
(each distinct ``POC p ref r`` of the ``EXEC`` labels).  A phase with no
sample inside has empty power fields and adds nothing.

    python -m vvc_affine_tpu_torch.cli ... | tee run.log    # under power_trace
    python -m vvc_affine_tpu_torch.tools.energy_report --trace trace.csv \\
        --log run.log
"""

from __future__ import annotations

import argparse
import csv
import re
import sys

_STAMP = re.compile(r"^(START|FINISHED) ([A-Za-z0-9_ .+-]+?),(\d+)\.(\d+),")
_FRAME_REF = re.compile(r"POC (\d+) ref (\d+)")


def parse_stamps(log_path):
    """(label, t_start, t_end) phases from START/FINISHED marker pairs."""
    opens = {}
    phases = []
    with open(log_path) as f:
        for line in f:
            m = _STAMP.match(line.strip())
            if not m:
                continue
            kind, label, sec, usec = m.groups()
            t = int(sec) + int(usec) / 10 ** len(usec)
            if kind == "START":
                opens[label] = t
            elif label in opens:
                phases.append((label, opens.pop(label), t))
    return phases


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def duty_cycle(phases, a, b):
    """Fraction of [a, b] covered by the union of the EXEC windows."""
    execs = _merge([(s, e) for lbl, s, e in phases if lbl.startswith("EXEC")])
    cov = sum(min(b, e) - max(a, s) for s, e in execs
              if min(b, e) > max(a, s))
    return cov / (b - a) if b > a else 0.0


def parse_trace(trace_path):
    """Sample rows (t_epoch, bytes_in_use, peak_bytes_in_use, power_w or
    None) and the power field's name (None without one)."""
    rows = []
    field = None
    with open(trace_path) as f:
        for row in csv.reader(f):
            if row[:1] == ["power_field"]:
                field = row[1]
            if not row or not row[0][:1].isdigit():
                continue
            pw = float(row[3]) if len(row) > 3 and row[3] else None
            rows.append((float(row[0]), int(row[1]), int(row[2]), pw))
    return rows, field


def phase_power(trace, a, b):
    """(mean W, J, distinct readings) of the samples in [a, b]; None when
    no sample with power lies there."""
    pw = [r[3] for r in trace if a <= r[0] <= b and r[3] is not None]
    if not pw:
        return None
    mean = sum(pw) / len(pw)
    return mean, mean * (b - a), len(set(pw))


def _power_block(trace, field, phases):
    readings = [r[3] for r in trace if r[3] is not None]
    print(f"power: {field}, {len(readings)} samples, "
          f"{len(set(readings))} distinct readings, max {max(readings):.2f} W")
    print("phase,mean_power_w,energy_j,distinct_power_readings,"
          "frame_refs,joules_per_frame_ref")
    for label, a, b in phases:
        p = phase_power(trace, a, b)
        print(f"{label},,,0,," if p is None else
              f"{label},{p[0]:.3f},{p[1]:.6f},{p[2]},,")
    execs = [(lbl, a, b) for lbl, a, b in phases if lbl.startswith("EXEC")]
    energy = seconds = 0.0
    for _, a, b in execs:
        p = phase_power(trace, a, b)
        if p is not None:
            energy += p[1]
            seconds += b - a
    distinct = len({r[3] for _, a, b in execs for r in trace
                    if a <= r[0] <= b and r[3] is not None})
    refs = {m.groups() for lbl, _, _ in execs
            for m in [_FRAME_REF.search(lbl)] if m}
    mean = f"{energy / seconds:.3f}" if seconds else ""
    per_ref = f"{energy / len(refs):.6f}" if refs else ""
    print(f"TOTAL_EXEC,{mean},{energy:.6f},{distinct},{len(refs)},{per_ref}")


def main(argv=None, device=None) -> int:
    """Print the report; 1 for an empty trace.  ``device`` is unused: the
    report reads files only (it is taken, as by every tool)."""
    ap = argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.energy_report",
        description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--trace", required=True, help="power_trace CSV")
    ap.add_argument("--log", required=True, help="run stdout with stamps")
    args = ap.parse_args(argv)

    trace, field = parse_trace(args.trace)
    phases = parse_stamps(args.log)
    if not trace:
        print("empty trace", file=sys.stderr)
        return 1

    t0, t1 = trace[0][0], trace[-1][0]
    peak = max(r[2] for r in trace)
    print(f"trace: {len(trace)} samples over {t1 - t0:.3f}s, "
          f"peak device bytes {peak}")
    print("phase,seconds,duty_cycle_pct,avg_bytes_in_use,samples")
    for label, a, b in phases:
        in_phase = [r for r in trace if a <= r[0] <= b]
        avg = sum(r[1] for r in in_phase) / len(in_phase) if in_phase else 0
        duty = 100.0 if label.startswith("EXEC") else \
            100.0 * duty_cycle(phases, a, b)
        print(f"{label},{b - a:.6f},{duty:.1f},{avg:.0f},{len(in_phase)}")
    total = sum(b - a for _, a, b in phases)
    lo = min(a for _, a, _ in phases)
    hi = max(b for _, _, b in phases)
    print(f"TOTAL_PHASE_TIME,{total:.6f},"
          f"{100.0 * duty_cycle(phases, lo, hi):.1f},,")
    if any(r[3] is not None for r in trace):
        _power_block(trace, field, phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
