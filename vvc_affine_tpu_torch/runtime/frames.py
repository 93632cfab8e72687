"""Frame ingest: CSV luma planes in the reference's interchange format.

Format (README.md:20, parse loop main.cpp:310-330): one CSV row per pixel
row, comma-separated unsigned-short luma samples, frames concatenated
vertically.  The original-frames file holds the frames to encode (POC 1..N);
the reference-frames file holds the reconstructed frames (POC 0..N-1).
"""

from __future__ import annotations

import numpy as np


def read_frames_csv(path: str, frame_w: int, frame_h: int, n_frames: int) -> np.ndarray:
    """Parse a concatenated-frames CSV -> uint16 [n_frames, frame_h, frame_w].

    Uses pandas' C parser when pandas is installed, else a line-by-line
    NumPy parser.  Out-of-range samples and short files raise.
    """
    rows_needed = frame_h * n_frames
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        df = pd.read_csv(
            path, header=None, nrows=rows_needed, dtype=np.int64,
            usecols=range(frame_w), engine="c",
        )
        vals = df.to_numpy()
    else:
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
    # loud out-of-range rejection (no silent uint16 truncation)
    if vals.size and (vals.min() < 0 or vals.max() > 65535):
        raise ValueError(f"{path}: sample value out of [0, 65535]")
    if vals.shape[0] < rows_needed:
        raise ValueError(
            f"{path}: {vals.shape[0]} rows, need {rows_needed} "
            f"({n_frames} frames x {frame_h})"
        )
    return vals.astype(np.uint16).reshape(n_frames, frame_h, frame_w)


def write_frames_csv(path: str, frames: np.ndarray) -> None:
    """Inverse of read_frames_csv (used to build test fixtures)."""
    n, h, w = frames.shape
    np.savetxt(path, np.asarray(frames).reshape(n * h, w), fmt="%d",
               delimiter=",")
