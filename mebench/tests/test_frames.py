"""The stream generator: deterministic per seed, and the NumPy original
(the port's ``testing.affine_gop``) frame for frame when both take the
same random draws."""

import numpy as np
import pytest
import torch

from mebench import frames, run
from vvc_affine_tpu_torch import testing

MOTION = run.load_json(f"{run.HERE}/mixes/ld4_stream.json")["motion"]


def test_deterministic_per_seed():
    a = frames.stream(96, 64, 3, 2**31 + 7, "cpu", MOTION)
    b = frames.stream(96, 64, 3, 2**31 + 7, "cpu", MOTION)
    c = frames.stream(96, 64, 3, 2**31 + 8, "cpu", MOTION)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    for t in a:
        assert t.dtype == torch.int16 and 0 <= int(t.min()) and int(t.max()) <= 1023


class _Recorded(frames.Draws):
    def __init__(self, seed, device):
        super().__init__(seed, device)
        self.log = []

    def random(self, shape):
        v = super().random(shape)
        self.log.append(v.numpy().copy())
        return v

    def normal(self, scale, shape):
        v = super().normal(scale, shape)
        self.log.append(v.numpy().copy())
        return v


class _Replay:
    """A NumPy generator that hands out the recorded draws in order."""

    def __init__(self, log):
        self.log = list(log)

    def random(self, shape):
        v = self.log.pop(0)
        assert v.shape == tuple(shape)
        return v

    def normal(self, loc, scale, size):
        v = self.log.pop(0)
        assert loc == 0.0 and v.shape == tuple(size)
        return v


@pytest.mark.parametrize("fw,fh,n", [(96, 64, 3), (160, 96, 4)])
def test_matches_numpy_original(monkeypatch, fw, fh, n):
    draws = _Recorded(1234, "cpu")
    orig, recon = frames.affine_gop(fw, fh, n, draws)
    monkeypatch.setattr(testing.np.random, "default_rng",
                        lambda seed: _Replay(draws.log))
    want_o, want_r = testing.affine_gop(fw, fh, n, seed=0)
    np.testing.assert_array_equal(orig.numpy(), want_o.astype(np.int16))
    np.testing.assert_array_equal(recon.numpy(), want_r.astype(np.int16))


def test_motion_scales_with_the_frame():
    """At twice the width, pixel motions double; the rest is relative."""
    seen = {}

    def fake(fw, fh, n, draws, **kw):
        seen[fw] = kw
        return None, None
    orig = frames.affine_gop
    frames.affine_gop = fake
    try:
        frames.stream(1920, 1080, 1, 1, "cpu", MOTION)
        frames.stream(3840, 2160, 1, 1, "cpu", MOTION)
    finally:
        frames.affine_gop = orig
    assert seen[3840]["pan_per_frame"] == tuple(2 * v for v in seen[1920]["pan_per_frame"])
    assert seen[3840]["obj_vel"] == tuple(2 * v for v in seen[1920]["obj_vel"])
    assert seen[3840]["zoom_per_frame"] == seen[1920]["zoom_per_frame"]
