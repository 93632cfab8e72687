"""Realistic affine-motion test content.

The reference's raison d'etre is Affine ME decisions on real video
(decision logs diffable against VTM, main_aux_functions.h:387-525); its
bundled 1080p frames are not part of this repository.  This module
synthesizes *affine-true* content in the same spirit: a smooth
multi-octave texture under a slowly evolving global affine model (pan +
zoom + rotation), a locally moving textured object, and light per-frame
"coding" noise on the reconstructed frames.  Unlike iid-noise fixtures,
this drives the engine the way camera footage does: informative
gradients, coherent sub-pel motion, CPMVs that converge onto a real affine
field, and a mix of small block displacements with a fast moving object.

Everything is plain NumPy (bilinear warps), deterministic per seed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def value_noise(h: int, w: int, rng: np.random.Generator,
                octaves: Tuple[int, ...] = (8, 16, 32, 64, 128),
                amps: Optional[Tuple[float, ...]] = None) -> np.ndarray:
    """Smooth multi-octave value noise in [0, 1], float64 [h, w].

    Each octave is a coarse uniform grid bilinearly upsampled to (h, w);
    finer octaves get smaller amplitudes, so the texture has energy at all
    scales (gradients informative at every CU size, 16x16 .. 128x128).
    """
    if amps is None:
        amps = tuple(1.0 / (i + 1) for i in range(len(octaves)))
    acc = np.zeros((h, w))
    ys = np.arange(h)
    xs = np.arange(w)
    for cells, amp in zip(octaves, amps):
        gh = max(2, h // cells + 2)
        gw = max(2, w // cells + 2)
        grid = rng.random((gh, gw))
        fy = ys / cells
        fx = xs / cells
        y0 = np.minimum(fy.astype(np.int64), gh - 2)
        x0 = np.minimum(fx.astype(np.int64), gw - 2)
        ty = (fy - y0)[:, None]
        tx = (fx - x0)[None, :]
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        acc += amp * ((1 - ty) * ((1 - tx) * g00 + tx * g01)
                      + ty * ((1 - tx) * g10 + tx * g11))
    acc -= acc.min()
    acc /= max(acc.max(), 1e-9)
    return acc


def _bilinear(tex: np.ndarray, sy: np.ndarray, sx: np.ndarray) -> np.ndarray:
    """Sample tex (float [H, W]) at float coords (sy, sx), edge-clamped."""
    H, W = tex.shape
    sy = np.clip(sy, 0.0, H - 1.000001)
    sx = np.clip(sx, 0.0, W - 1.000001)
    y0 = sy.astype(np.int64)
    x0 = sx.astype(np.int64)
    ty = sy - y0
    tx = sx - x0
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return ((1 - ty) * ((1 - tx) * t00 + tx * t01)
            + ty * ((1 - tx) * t10 + tx * t11))


def affine_gop(
    fw: int,
    fh: int,
    n_frames: int,
    seed: int = 0,
    pan_per_frame: Tuple[float, float] = (2.0, -1.5),   # (dy, dx) px/frame
    zoom_per_frame: float = 0.002,                      # relative scale/frame
    rot_deg_per_frame: float = 0.12,
    obj_frac: float = 0.08,        # moving-object size as a frame fraction
    obj_vel: Tuple[float, float] = (6.0, 9.0),          # px/frame (dy, dx)
    recon_noise: float = 1.5,      # sigma of "coding noise" on recon frames
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesize an affine-true GOP in the reference's data model.

    Returns (orig, recon), both uint16 [n_frames, fh, fw] 10-bit:
    orig[t] is the frame to encode at POC t+1, recon[t] the reconstructed
    reference at POC t (the original of POC t plus light coding noise) —
    exactly the two CSV inputs of the reference binary (main.cpp:310-330).

    Motion model per frame index t (0 = the POC-0 reference):
      global: translation t * pan, scale (1 + zoom)^t, rotation t * rot
              about the frame center — an exact affine field;
      local:  a soft-edged textured object (obj_frac of the frame diagonal)
              translating at obj_vel on top of the global field — the
              fast outlier whose windows reach far from their blocks.

    Defaults at 1080p: global corner displacement ~4.5 px/frame, object at
    ~11 px/frame.
    """
    rng = np.random.default_rng(seed)
    # displacement margin: pan + (zoom + rot) * corner radius, per frame
    rad = math.hypot(fw, fh) / 2
    per = (abs(pan_per_frame[0]) + abs(pan_per_frame[1])
           + (abs(zoom_per_frame) + abs(rot_deg_per_frame) * math.pi / 180)
           * rad)
    margin = int(math.ceil(per * n_frames)) + 8
    th, tw = fh + 2 * margin, fw + 2 * margin
    tex = value_noise(th, tw, rng) * 1023.0

    # the moving object: its own texture + a soft circular alpha mask
    osz = max(16, int(obj_frac * math.hypot(fw, fh)))
    otex = value_noise(osz, osz, rng, octaves=(4, 8, 16)) * 1023.0
    oy, ox = np.mgrid[0:osz, 0:osz]
    r = np.hypot(oy - (osz - 1) / 2, ox - (osz - 1) / 2) / (osz / 2)
    alpha = np.clip((0.95 - r) / 0.15, 0.0, 1.0)

    cy, cx = (fh - 1) / 2, (fw - 1) / 2
    yy, xx = np.mgrid[0:fh, 0:fw].astype(np.float64)

    def frame_at(t: float) -> np.ndarray:
        # inverse map: output pixel -> source texture coordinate
        s = (1.0 + zoom_per_frame) ** (-t)
        a = -math.radians(rot_deg_per_frame) * t
        ca, sa = math.cos(a) * s, math.sin(a) * s
        dy = yy - cy - pan_per_frame[0] * t
        dx = xx - cx - pan_per_frame[1] * t
        sy = cy + margin + ca * dy - sa * dx
        sx = cx + margin + sa * dy + ca * dx
        out = _bilinear(tex, sy, sx)
        # composite the object at its own (translating) position
        py = fh * 0.30 + obj_vel[0] * t
        px = fw * 0.25 + obj_vel[1] * t
        y0 = int(round(py))
        x0 = int(round(px))
        y1, x1 = y0 + osz, x0 + osz
        ys0, xs0 = max(0, -y0), max(0, -x0)
        y0c, x0c = max(0, y0), max(0, x0)
        y1c, x1c = min(fh, y1), min(fw, x1)
        if y1c > y0c and x1c > x0c:
            sub = np.s_[ys0:ys0 + (y1c - y0c), xs0:xs0 + (x1c - x0c)]
            am = alpha[sub]
            out[y0c:y1c, x0c:x1c] = (
                (1 - am) * out[y0c:y1c, x0c:x1c] + am * otex[sub])
        return out

    seq = [frame_at(t) for t in range(n_frames + 1)]
    q = lambda f: np.clip(np.rint(f), 0, 1023).astype(np.uint16)
    orig = np.stack([q(f) for f in seq[1:]])
    recon = np.stack([
        q(f + rng.normal(0.0, recon_noise, size=f.shape)) for f in seq[:-1]])
    return orig, recon
