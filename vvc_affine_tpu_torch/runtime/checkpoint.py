"""GOP-level checkpoint/resume for the encoding pipeline.

The same marker file and log pruning as the JAX package's
``runtime/checkpoint.py``.  The reference has no recovery story
(probe_error prints and continues, main_aux_functions.h:70-75; a crash
loses the run).  Here:

* after every completed frame (all refIdx x pred-type results flushed to the
  decision logs) a marker, written atomically, records the finished POC;
* on restart the pipeline prunes the log rows of frames after the marker
  (rows carry their POC, so a partly written frame is filtered exactly) and
  re-enters the frame loop at the next POC.

Reference-picture state needs no persistence: the 4-slot circular buffer
with long-term retention is a deterministic function of the POC sequence
(main.cpp:578-707), and reconstructed frames are re-read from the input CSV.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from vvc_affine_tpu_torch.runtime import reporting

_MARKER = "checkpoint.json"


class CheckpointManager:
    def __init__(self, ckpt_dir: str, log_prefix: Optional[str]):
        self.dir = ckpt_dir
        self.log_prefix = log_prefix
        os.makedirs(ckpt_dir, exist_ok=True)

    @property
    def _path(self) -> str:
        return os.path.join(self.dir, _MARKER)

    def completed_poc(self) -> int:
        """Last fully-completed POC (0 = nothing done)."""
        try:
            with open(self._path) as f:
                return int(json.load(f)["completed_poc"])
        except (FileNotFoundError, ValueError, KeyError):
            return 0

    def mark_frame_done(self, poc: int) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed_poc": poc}, f)
        os.replace(tmp, self._path)

    def prune_logs_after(self, poc: int) -> None:
        """Drop decision-log rows of frames newer than ``poc`` (partial);
        the header stays."""
        if self.log_prefix is None:
            return
        for pred in range(4):
            for path in reporting.log_paths(self.log_prefix, pred):
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    lines = f.readlines()
                kept = [lines[0]] if lines else []
                for ln in lines[1:]:
                    try:
                        if int(ln.split(",", 1)[0]) <= poc:
                            kept.append(ln)
                    except ValueError:
                        pass
                with open(path, "w") as f:
                    f.writelines(kept)

    def clear(self) -> None:
        """Remove the marker: the next run starts from the first frame."""
        try:
            os.remove(self._path)
        except FileNotFoundError:
            pass


class FollowerCheckpoint:
    """The checkpoint of a process other than process 0 in a run of several
    processes (``runtime.distributed``).

    Every process must skip the same completed frames: the result gathers
    are collective, so a process that ran a frame the others skipped would
    wait for them until the collectives time out.  Only process 0 owns the
    marker file and the decision logs, so the others get its completed POC
    at start-up (``distributed.broadcast_scalar``) and write nothing.
    """

    def __init__(self, done_poc: int):
        self._done = int(done_poc)

    def completed_poc(self) -> int:
        return self._done

    def mark_frame_done(self, poc: int) -> None:
        pass

    def prune_logs_after(self, poc: int) -> None:
        pass

    def clear(self) -> None:
        pass
