"""The benchmark's plain reference gives the JAX package's decisions, bit
for bit, at 416x240 (8 CTUs, the bottom row partly outside the frame), for
both modes and both stages (2CP, and 3CP fed from it).  This test may load
JAX; the benchmark may not.  The JAX pairs compile on its exact XLA path
in child processes with a raised stack limit, as the repository's
``tests/test_torch_stage.py`` does."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mebench import frames, reference, run

FW, FH = 416, 240
ROOT = os.path.dirname(run.HERE)

_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from vvc_affine_tpu.models import affine_plane as ap
mode, inp, out = sys.argv[1], sys.argv[2], sys.argv[3]
d = np.load(inp)
fw, fh = int(d["fw"]), int(d["fh"])
s2 = ap.PlaneSpec(mode, 2, fw, fh, use_pallas=False)
s3 = ap.PlaneSpec(mode, 3, fw, fh, use_pallas=False)
res = ap.build_pair_stage(s2, s3)(jnp.asarray(d["ref"]), jnp.asarray(d["orig"]),
                                  jnp.float32(d["lam"]), ap.zero_cpmvs(s2))
np.savez(out, *[np.asarray(r) for r in res])
"""


def _raise_stack():
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
    want = 1 << 29
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_STACK, (
            want if hard == resource.RLIM_INFINITY else min(want, hard), hard))


@pytest.fixture(scope="module")
def inputs():
    mix = run.load_json(os.path.join(run.HERE, "mixes", "ld4_stream.json"))
    o, r = frames.stream(FW, FH, 4, 2**31 + 99, "cpu", mix["motion"])
    poc, k = 4, 2
    ref = r[reference.reference_lists(4)[poc][k]].to(torch.int32).reshape(-1)
    orig = o[poc - 1].to(torch.int32).reshape(-1)
    return ref, orig, reference.lambda_for(32, poc)


@pytest.fixture(scope="module")
def jax_pairs(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    ref, orig, lam = inputs
    inp = str(tmp / "in.npz")
    np.savez(inp, ref=ref.numpy(), orig=orig.numpy(), lam=np.float32(lam),
             fw=FW, fh=FH)
    env = dict(os.environ, JAX_PLATFORMS="cpu", VVC_AFFINE_TPU_PLATFORM="cpu")
    procs = {m: (str(tmp / f"{m}.npz"), subprocess.Popen(
        [sys.executable, "-c", _CHILD, m, inp, str(tmp / f"{m}.npz")],
        env=env, cwd=ROOT, preexec_fn=_raise_stack, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for m in ("full", "half")}
    out = {}
    for m, (path, p) in procs.items():
        _, err = p.communicate(timeout=1800)
        assert p.returncode == 0, err[-2000:]
        with np.load(path) as z:
            out[m] = [z[f"arr_{i}"] for i in range(4)]
    return out


@pytest.mark.parametrize("mode", ["full", "half"])
def test_reference_equals_jax(inputs, jax_pairs, mode):
    ref, orig, lam = inputs
    got = reference.frame_ref(ref, orig, FW, FH, lam, modes=(mode,))
    want = jax_pairs[mode]
    for j, n_cp in enumerate((2, 3)):
        c, p = got[(mode, n_cp)]
        np.testing.assert_array_equal(c.numpy(), want[2 * j])
        np.testing.assert_array_equal(p.numpy(), want[2 * j + 1])
