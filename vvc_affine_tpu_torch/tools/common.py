"""What the tools share: ``nvidia-smi`` for the card a CUDA device is, the
``WxH`` argument, output paths and timing.

CUDA numbers the cards in its own order (``CUDA_VISIBLE_DEVICES``, fastest
first), which need not be ``nvidia-smi``'s, so a card is matched by its
UUID: ``torch.cuda.get_device_properties(i).uuid`` against ``nvidia-smi
--query-gpu=uuid``.  Every ``nvidia-smi`` call raises when it fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch


# the directory that holds the package: a child process imports it there
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def python_child(code: str, *args: str, **popen_kw) -> subprocess.Popen:
    """``python -c code args...`` started in ``PACKAGE_PARENT``."""
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            cwd=PACKAGE_PARENT, **popen_kw)


def smi(*args: str, timeout: float = 60) -> str:
    """``nvidia-smi <args>``'s standard output; raises when it fails."""
    return subprocess.run(["nvidia-smi", *args], capture_output=True,
                          text=True, timeout=timeout, check=True).stdout


def _uuid(u) -> str:
    u = str(u).strip().lower()
    return u[4:] if u.startswith("gpu-") else u


def card_index(device: torch.device) -> str:
    """``nvidia-smi``'s index of the card that CUDA ``device`` is."""
    want = _uuid(torch.cuda.get_device_properties(device).uuid)
    for line in smi("--query-gpu=index,uuid",
                    "--format=csv,noheader").splitlines():
        index, uuid = (f.strip() for f in line.split(","))
        if _uuid(uuid) == want:
            return index
    raise RuntimeError(f"nvidia-smi lists no card with the UUID of {device} "
                       f"({want})")


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    return smi("-i", card_index(device), "--query-gpu=name,power.limit",
               "--format=csv,noheader").strip()


def frame_size(text: str):
    """argparse type of the positional ``WxH``: (width, height)."""
    try:
        w, h = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{text!r} is not WxH (e.g. 1920x1080)") from None
    if w <= 0 or h <= 0:
        raise argparse.ArgumentTypeError(f"{text!r}: sizes must be positive")
    return w, h


def temp_path(prefix: str, suffix: str) -> str:
    """A new empty temporary file: where a tool writes without ``--out``."""
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=suffix)
    os.close(fd)
    return path


def sync(devices) -> None:
    """Wait for the work queued on every CUDA device of ``devices``."""
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def median_ms(fn, device: torch.device, n: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``n`` runs after a warm one:
    CUDA events around each run on the card, the host clock (after the
    run) on the CPU."""
    fn()
    sync([device])
    times = []
    for _ in range(n):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]
