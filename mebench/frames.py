"""Synthetic affine-true video, made on the device from the seed.

The CTC sequences are not in the repository, so a stream is a smooth
multi-octave texture under a global affine motion (pan, zoom and rotation
about the centre), a textured object moving fast on top of it, and light
"coding" noise on the reconstructed frames: content on which affine ME
does real work (informative gradients, sub-pel motion that an affine field
explains, a fast outlier).  It is the algorithm of the port's
``testing.affine_gop`` rewritten in PyTorch, so that 4K frames take
milliseconds on the card instead of seconds in NumPy on the host; with the
same random draws it gives the same frames (``mebench/tests/test_frames.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


class Draws:
    """The random numbers of one stream, drawn from one generator on the
    device in a fixed order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def random(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, dtype=torch.float64,
                          device=self.device)

    def normal(self, scale: float, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, dtype=torch.float64,
                           device=self.device) * scale


def value_noise(h, w, draws, octaves=(8, 16, 32, 64, 128)) -> torch.Tensor:
    """Multi-octave value noise in [0, 1], float64 [h, w]: each octave a
    coarse uniform grid, bilinearly upsampled, at amplitude 1/(i+1)."""
    dev = draws.device
    acc = torch.zeros((h, w), dtype=torch.float64, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float64)
    xs = torch.arange(w, device=dev, dtype=torch.float64)
    for i, cells in enumerate(octaves):
        amp = 1.0 / (i + 1)
        gh, gw = max(2, h // cells + 2), max(2, w // cells + 2)
        grid = draws.random((gh, gw))
        fy, fx = ys / cells, xs / cells
        y0 = fy.to(torch.int64).clamp(max=gh - 2)
        x0 = fx.to(torch.int64).clamp(max=gw - 2)
        ty = (fy - y0)[:, None]
        tx = (fx - x0)[None, :]
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        acc += amp * ((1 - ty) * ((1 - tx) * g00 + tx * g01)
                      + ty * ((1 - tx) * g10 + tx * g11))
    acc -= acc.min()
    acc /= max(float(acc.max()), 1e-9)
    return acc


def _bilinear(tex, sy, sx):
    H, W = tex.shape
    sy = sy.clamp(0.0, H - 1.000001)
    sx = sx.clamp(0.0, W - 1.000001)
    y0 = sy.to(torch.int64)
    x0 = sx.to(torch.int64)
    ty = sy - y0
    tx = sx - x0
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return ((1 - ty) * ((1 - tx) * t00 + tx * t01)
            + ty * ((1 - tx) * t10 + tx * t11))


def affine_gop(fw: int, fh: int, n_frames: int, draws: Draws,
               pan_per_frame: Tuple[float, float] = (2.0, -1.5),
               zoom_per_frame: float = 0.002,
               rot_deg_per_frame: float = 0.12,
               obj_frac: float = 0.08,
               obj_vel: Tuple[float, float] = (6.0, 9.0),
               recon_noise: float = 1.5):
    """(orig, recon), int16 tensors [n_frames, fh, fw] of 10-bit
    samples on the draws' device: orig[t] is the frame of POC t+1,
    recon[t] the reconstructed reference of POC t.  Motions are in pixels
    (dy, dx) per frame; see the module docstring."""
    dev = draws.device
    rad = math.hypot(fw, fh) / 2
    per = (abs(pan_per_frame[0]) + abs(pan_per_frame[1])
           + (abs(zoom_per_frame) + abs(rot_deg_per_frame) * math.pi / 180)
           * rad)
    margin = int(math.ceil(per * n_frames)) + 8
    th, tw = fh + 2 * margin, fw + 2 * margin
    tex = value_noise(th, tw, draws) * 1023.0

    osz = max(16, int(obj_frac * math.hypot(fw, fh)))
    otex = value_noise(osz, osz, draws, octaves=(4, 8, 16)) * 1023.0
    oy = torch.arange(osz, device=dev, dtype=torch.float64)[:, None]
    ox = torch.arange(osz, device=dev, dtype=torch.float64)[None, :]
    r = torch.hypot(oy - (osz - 1) / 2, ox - (osz - 1) / 2) / (osz / 2)
    alpha = ((0.95 - r) / 0.15).clamp(0.0, 1.0)

    cy, cx = (fh - 1) / 2, (fw - 1) / 2
    yy = torch.arange(fh, device=dev, dtype=torch.float64)[:, None].expand(fh, fw)
    xx = torch.arange(fw, device=dev, dtype=torch.float64)[None, :].expand(fh, fw)

    def frame_at(t: int) -> torch.Tensor:
        s = (1.0 + zoom_per_frame) ** (-t)
        a = -math.radians(rot_deg_per_frame) * t
        ca, sa = math.cos(a) * s, math.sin(a) * s
        dy = yy - cy - pan_per_frame[0] * t
        dx = xx - cx - pan_per_frame[1] * t
        sy = cy + margin + ca * dy - sa * dx
        sx = cx + margin + sa * dy + ca * dx
        out = _bilinear(tex, sy, sx)
        y0 = int(round(fh * 0.30 + obj_vel[0] * t))
        x0 = int(round(fw * 0.25 + obj_vel[1] * t))
        ys0, xs0 = max(0, -y0), max(0, -x0)
        y0c, x0c = max(0, y0), max(0, x0)
        y1c, x1c = min(fh, y0 + osz), min(fw, x0 + osz)
        if y1c > y0c and x1c > x0c:
            am = alpha[ys0:ys0 + (y1c - y0c), xs0:xs0 + (x1c - x0c)]
            ot = otex[ys0:ys0 + (y1c - y0c), xs0:xs0 + (x1c - x0c)]
            out[y0c:y1c, x0c:x1c] = (1 - am) * out[y0c:y1c, x0c:x1c] + am * ot
        return out

    q = lambda f: f.round().clamp(0, 1023).to(torch.int16)
    orig = torch.empty((n_frames, fh, fw), dtype=torch.int16, device=dev)
    recon = torch.empty_like(orig)
    prev = frame_at(0)
    for t in range(n_frames):
        recon[t] = q(prev + draws.normal(recon_noise, (fh, fw)))
        prev = frame_at(t + 1)
        orig[t] = q(prev)
    return orig, recon


def stream(fw: int, fh: int, n_frames: int, seed: int, device, motion: dict):
    """The mix's stream at this frame size: ``motion`` gives pixel motions
    at the width ``at_width``; they scale with the frame (zoom, rotation
    and the object's share of the frame are relative already)."""
    k = fw / motion["at_width"]
    return affine_gop(
        fw, fh, n_frames, Draws(seed, device),
        pan_per_frame=tuple(k * v for v in motion["pan_px"]),
        zoom_per_frame=motion["zoom"],
        rot_deg_per_frame=motion["rot_deg"],
        obj_frac=motion["obj_frac"],
        obj_vel=tuple(k * v for v in motion["obj_vel_px"]),
        recon_noise=motion["recon_noise"])
