"""Dynamic (row, lane) windows into an on-chip tile: the six probes of the
JAX repository's ``tools/mosaic_probe.py``, on an NVIDIA card.

The TPU tool asks whether Mosaic can lower a window at a dynamic offset into
a VMEM-resident tile.  On the card each probe is a kernel
(``csrc/window_probe.cu``) that stages the tile in shared memory and reads
the window there.  Every probe reads x int16 [176, 256] and an int offset s
and returns int32 [8, 128] (``n`` is 48 rows for ``k_d_rows``, 256 lanes for
``k_d_lanes``):

  ===========  ==============================================  ===============
  probe        window                                          defined for
  ===========  ==============================================  ===============
  k_a          ``x[8s : 8s+8, 0:128]``                         0 <= s <= 21
  k_b          ``out[i, j] = x[(i - s) mod 48, j]``            every int32 s
  k_c          ``out[i, j] = x[i, (j - s) mod 256]``           every int32 s
  k_d_rows     ``x[c : c+8, 0:128]``, c = clamp(start, 0, 40)  every int32 s
  k_d_lanes    ``x[0:8, c : c+128]``, c = clamp(start, 0, 128) every int32 s
  k_e          ``x[0:8, s : s+128]``                           0 <= s <= 128
  ===========  ==============================================  ===============

``start`` is s + n for s < 0, else s: ``lax.dynamic_slice`` counts a
negative start from the end before it clamps.  ``k_b`` and ``k_c`` roll the
way ``jnp.roll`` does (row 0 of ``k_b`` at s = 13 is source row 35), which is
what the TPU tool's kernels give in interpret mode; the comment beside
``k_b`` in that tool states the opposite direction.

* ``probe_plain``: the plain PyTorch version (``torch.roll``, slicing).
* ``probe``: the wrapper.  On a CUDA tensor it launches the probe's kernel;
  on a CPU tensor it runs the plain version.  It raises for an offset
  outside the probe's defined range.
* ``expected``: the same window in numpy, by index, as the tool's checks.

    python -m vvc_affine_tpu_torch.tools.mosaic_probe

runs the tool's six cases on the tool's input on ``cuda`` (``main(device=
"cpu")`` runs them on the CPU), prints one line per probe and exits non-zero
when any window differs from ``expected``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vvc_affine_tpu_torch import kernels, resolve_device

X_SHAPE = (176, 256)
OUT_SHAPE = (8, 128)
_ROLL_ROWS = 48          # k_b and k_d_rows read rows 0:48

# probe -> (the line the TPU tool prints for it, the tool's offset)
PROBES = {
    "k_a": ("a_refload_mult8", 2),
    "k_b": ("b_roll_rows_dyn", 13),
    "k_c": ("c_roll_lanes_dyn", 37),
    "k_d_rows": ("d_dynslice_rows", 13),
    "k_d_lanes": ("d_dynslice_lanes", 37),
    "k_e": ("e_refload_dynlane", 37),
}

# the tool's offset, then the edges of each probe's defined range: the
# largest valid start, a wrap past n, a clamped start, a negative one
CASES = {
    "k_a": (2, 0, 21),
    "k_b": (13, 0, 47, 61, -5),
    "k_c": (37, 0, 255, 293, -3),
    "k_d_rows": (13, 0, 40, 45, -3, -60),
    "k_d_lanes": (37, 0, 128, 200, -1, -300),
    "k_e": (37, 0, 128),
}

# offsets outside these ranges are undefined on the TPU (out of range); every
# probe's offset is an int32 scalar there, as it is the kernel's argument here
_INT32 = (-2**31, 2**31 - 1)
_DEFINED = {"k_a": (0, (X_SHAPE[0] - OUT_SHAPE[0]) // 8),
            "k_e": (0, X_SHAPE[1] - OUT_SHAPE[1])}


def _offset(name: str, s) -> int:
    """``s`` as an int; raises for an unknown probe or an undefined offset."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; one of {sorted(PROBES)}")
    s = int(s)
    lo, hi = _DEFINED.get(name, _INT32)
    if not lo <= s <= hi:
        raise ValueError(f"{name}: offset {s} is outside [{lo}, {hi}], where "
                         f"the window is undefined")
    return s


def _start(s: int, n: int, size: int) -> int:
    """``lax.dynamic_slice``'s start: negative from the end, then clamped."""
    return min(max(s + n if s < 0 else s, 0), n - size)


def probe_plain(name: str, x: torch.Tensor, s) -> torch.Tensor:
    """Plain PyTorch version of probe ``name`` (``probe``'s contract)."""
    s = _offset(name, s)
    oh, ow = OUT_SHAPE
    if name == "k_a":
        w = x[8 * s:8 * s + oh, 0:ow]
    elif name == "k_b":
        w = torch.roll(x[0:_ROLL_ROWS, 0:ow], s, 0)[0:oh]
    elif name == "k_c":
        w = torch.roll(x[0:oh, :], s, 1)[:, 0:ow]
    elif name == "k_d_rows":
        c = _start(s, _ROLL_ROWS, oh)
        w = x[c:c + oh, 0:ow]
    elif name == "k_d_lanes":
        c = _start(s, x.shape[1], ow)
        w = x[0:oh, c:c + ow]
    else:
        w = x[0:oh, s:s + ow]
    return w.to(torch.int32)


def expected(name: str, x: np.ndarray, s) -> np.ndarray:
    """The window of probe ``name`` in numpy, by row and lane index."""
    s = _offset(name, s)
    rows, lanes = np.arange(OUT_SHAPE[0]), np.arange(OUT_SHAPE[1])
    if name == "k_a":
        rows = rows + 8 * s
    elif name == "k_b":
        rows = (rows - s) % _ROLL_ROWS
    elif name == "k_c":
        lanes = (lanes - s) % x.shape[1]
    elif name == "k_d_rows":
        rows = rows + _start(s, _ROLL_ROWS, OUT_SHAPE[0])
    elif name == "k_d_lanes":
        lanes = lanes + _start(s, x.shape[1], OUT_SHAPE[1])
    else:
        lanes = lanes + s
    return x[np.ix_(rows, lanes)].astype(np.int32)


def probe(name: str, x: torch.Tensor, s) -> torch.Tensor:
    """Window of probe ``name`` at offset ``s``: int32 [8, 128].

    x: int16 [176, 256].  Launches the probe's kernel for a CUDA tensor and
    runs ``probe_plain`` for a CPU tensor.
    """
    if x.device.type == "cpu":
        if x.dtype != torch.int16 or tuple(x.shape) != X_SHAPE:
            raise ValueError(f"x: expected int16 {X_SHAPE}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        return probe_plain(name, x, s)
    out, run = bind_probe(name, x, s)
    run()
    return out


def bind_probe(name: str, x: torch.Tensor, s):
    """Probe ``name`` bound to a CUDA ``x`` and offset ``s`` (``probe``'s
    contract): returns the output tensor and a callable that launches the
    kernel into it."""
    s = _offset(name, s)
    kernels.check(x, torch.int16, X_SHAPE, "x")
    out = torch.empty(OUT_SHAPE, dtype=torch.int32, device=x.device)
    return out, kernels.bind(f"probe_{name}", x.device, out, x, s)


def tool_input() -> np.ndarray:
    """The TPU tool's x: int16 [176, 256] from default_rng(0)."""
    return np.random.default_rng(0).integers(0, 1024, X_SHAPE).astype(
        np.int16)


def main(argv=None, device=None) -> int:
    """Run the tool's six cases; 0 when every window is right, else 1.
    ``device`` overrides ``cuda`` (the tests pass ``device="cpu"``)."""
    argparse.ArgumentParser(
        prog="python -m vvc_affine_tpu_torch.tools.mosaic_probe",
        description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(device)
    x_np = tool_input()
    x = torch.from_numpy(x_np).to(dev)
    failed = []
    for name, (label, s) in PROBES.items():
        out = probe(name, x, s).cpu().numpy()
        ok = (out.dtype == np.int32 and out.shape == OUT_SHAPE
              and np.array_equal(out, expected(name, x_np, s)))
        print(f"{label}: {'PASS' if ok else 'FAIL'}  sum={out.sum()}  "
              f"({name}, s={s}, {dev})", flush=True)
        if not ok:
            failed.append(name)
    print(f"probe failed: {', '.join(failed)}" if failed else "probe done")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
