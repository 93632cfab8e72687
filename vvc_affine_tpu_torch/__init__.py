"""vvc_affine_tpu_torch — the VVC Affine Motion Estimation engine in PyTorch.

The same stage contract, frame loop, CLI flags and decision-log bytes as the
JAX package ``vvc_affine_tpu``, in PyTorch on an NVIDIA card, where each
stage of either engine and each plane 2CP->3CP pair runs as one captured
CUDA graph (``runtime/graphs.py``, the counterpart of the JAX package's
``jax.jit``); on the CPU everything runs eagerly.
The three kernels of the dense plane engine — the motion planes (each 4x4
block's displacement and filter phase from its CU's CPMVs), the warp
(motion-compensated prediction of every 4x4 block of a CTU plane) and the
block reduction (SATD, Sobel gradients and the five normal-equation
moments) — are hand-written CUDA (``csrc/``), built with ``nvcc`` at first
use (``kernels.py``), as are the six window probes of
``tools/mosaic_probe.py``.  Every kernel wrapper keeps a plain PyTorch
version of the same function, which it runs only for tensors on the CPU;
the tests hold the port against the JAX package on the CPU through those
plain versions.  The gather engine (``models/affine_me``,
``--Engine gather``) has no kernel of its own: plain PyTorch ops on any
device, captured as one CUDA graph per stage on a card.  The CSV ingest
and the decision-log writer are native C++ (``native/``), built with
``g++`` at first use.

Entry points (``models.affine_plane.build_stage``/``build_pair_stage``,
``models.affine_me.build_stage``, ``models.pipeline.AffineMEPipeline``,
``parallel.mesh.make_mesh``, ``cli.main`` and the ``main`` of every tool in
``tools/`` but ``energy_report``, which reads files only) run on ``cuda``
unless the caller passes ``device="cpu"``; with no card they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.

    A CUDA device always comes back with its index (``cuda`` becomes
    ``cuda:<current device>``), so it compares equal to the device of every
    tensor made on it.  Raises when the resolved device is a CUDA device and
    no card is present: the port never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
