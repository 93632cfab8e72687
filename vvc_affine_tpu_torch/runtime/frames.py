"""Frame ingest: CSV luma planes in the reference's interchange format.

Format (README.md:20, parse loop main.cpp:310-330): one CSV row per pixel
row, comma-separated unsigned-short luma samples, frames concatenated
vertically.  The original-frames file holds the frames to encode (POC 1..N);
the reference-frames file holds the reconstructed frames (POC 0..N-1).
"""

from __future__ import annotations

import numpy as np

from vvc_affine_tpu_torch import constants as C
from vvc_affine_tpu_torch import native


def check_samples(frames, what: str) -> None:
    """Raise ValueError unless every sample lies in [0, 1023].

    The engine takes 10-bit luma, as the reference encoder does
    (CLP_RNG_MAX): the warp kernel packs reference samples as int16 pairs
    and is exact only there.  Every entry point that takes host frames
    calls this once per frame.
    """
    a = np.asarray(frames)
    if a.size and (a.min() < C.CLP_RNG_MIN or a.max() > C.CLP_RNG_MAX):
        raise ValueError(f"{what}: sample value out of "
                         f"[{C.CLP_RNG_MIN}, {C.CLP_RNG_MAX}] (10-bit)")


def read_frames_csv(path: str, frame_w: int, frame_h: int, n_frames: int) -> np.ndarray:
    """Parse a concatenated-frames CSV -> uint16 [n_frames, frame_h, frame_w].

    Uses the native mmap parser (``native.parse_luma_csv``, the analogue of
    the reference's C++ parse loop, main.cpp:310-330).  A short file, a
    malformed field or a value above 65535 raises ValueError with the row;
    a file that cannot be opened raises OSError; samples outside [0, 1023]
    (``check_samples``) raise ValueError.
    """
    vals = native.parse_luma_csv(path, frame_h * n_frames, frame_w)
    check_samples(vals, path)
    return vals.reshape(n_frames, frame_h, frame_w)


def read_frames_csv_plain(path: str, frame_w: int, frame_h: int,
                          n_frames: int) -> np.ndarray:
    """The plain version of ``read_frames_csv``: a line-by-line NumPy
    parser, with the same result and the same refusals of short files and
    of samples outside [0, 1023]."""
    rows_needed = frame_h * n_frames
    vals = np.empty((rows_needed, frame_w), np.int64)
    with open(path, "r") as f:
        for r in range(rows_needed):
            line = f.readline()
            if not line:
                raise ValueError(
                    f"{path}: ran out of rows at {r} (need {rows_needed})"
                )
            vals[r] = np.array(
                line.rstrip("\n").rstrip(",").split(",")[:frame_w],
                np.int64)
    check_samples(vals, path)
    return vals.astype(np.uint16).reshape(n_frames, frame_h, frame_w)


def write_frames_csv(path: str, frames: np.ndarray) -> None:
    """Inverse of read_frames_csv (used to build test fixtures)."""
    n, h, w = frames.shape
    np.savetxt(path, np.asarray(frames).reshape(n * h, w), fmt="%d",
               delimiter=",")
