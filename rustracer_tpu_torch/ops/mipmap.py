"""MIP pyramids (port of rustracer_tpu/ops/mipmap.py: the wrap modes, the
host-side pyramid build and the one-level bilinear lookup, which the
infinite lights' maps use).

The per-texture lookups (``lookup_trilinear``, ``lookup_ewa``,
``lookup_ewa_exact``) are not ported yet (ROADMAP.md, section A, item 13);
image textures are served through the shared atlas (scene/atlas.py).
"""
from __future__ import annotations

import numpy as np
import torch

WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP = 0, 1, 2


def build_pyramid(img: np.ndarray):
    """Host-side pyramid build: bilinear resample to power-of-two sides,
    then 2x box filtering down to 1x1. -> list of float32 (H, W, C)
    levels, bit-equal with the reference's."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    h2 = 1 << int(np.ceil(np.log2(max(1, h))))
    w2 = 1 << int(np.ceil(np.log2(max(1, w))))
    if (h2, w2) != (h, w):
        yi = np.linspace(0, h - 1, h2)
        xi = np.linspace(0, w - 1, w2)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        img = ((1 - fy) * (1 - fx) * img[y0][:, x0]
               + (1 - fy) * fx * img[y0][:, x1]
               + fy * (1 - fx) * img[y1][:, x0]
               + fy * fx * img[y1][:, x1]).astype(np.float32)
        h, w = h2, w2
    levels = [img]
    while h > 1 or w > 1:
        nh, nw = max(1, h // 2), max(1, w // 2)
        cur = levels[-1][: nh * 2, : nw * 2]
        if h == 1:
            nxt = 0.5 * (cur[:, 0::2] + cur[:, 1::2])
        elif w == 1:
            nxt = 0.5 * (cur[0::2] + cur[1::2])
        else:
            nxt = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(nxt.astype(np.float32))
        h, w = nh, nw
    return levels


def _texel(level, s_i, t_i, wrap):
    """Texels (B, C) of one level (H, W, C) at integer (s_i, t_i) (B,)
    under ``wrap`` (REPEAT a floor modulo, CLAMP to the edge, BLACK zero
    outside)."""
    h, w = level.shape[0], level.shape[1]
    mask = None
    if wrap == WRAP_REPEAT:
        s_i, t_i = torch.remainder(s_i, w), torch.remainder(t_i, h)
    else:
        if wrap == WRAP_BLACK:
            mask = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
        s_i, t_i = torch.clamp(s_i, 0, w - 1), torch.clamp(t_i, 0, h - 1)
    v = level[t_i.long(), s_i.long()]
    return v if mask is None else torch.where(mask[:, None], v, 0.0)


def bilerp_level(level, st, wrap):
    """Bilinear lookup of one level (H, W, C) at continuous st (B, 2) in
    texel units of [0, 1)^2, centres at half-integers -> (B, C)."""
    h, w = level.shape[0], level.shape[1]
    s = st[:, 0] * w - 0.5
    t = st[:, 1] * h - 0.5
    s0 = torch.floor(s).int()
    t0 = torch.floor(t).int()
    ds = (s - s0)[:, None]
    dt = (t - t0)[:, None]
    v00 = _texel(level, s0, t0, wrap)
    v10 = _texel(level, s0 + 1, t0, wrap)
    v01 = _texel(level, s0, t0 + 1, wrap)
    v11 = _texel(level, s0 + 1, t0 + 1, wrap)
    return (1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + \
        (1 - ds) * dt * v01 + ds * dt * v11
