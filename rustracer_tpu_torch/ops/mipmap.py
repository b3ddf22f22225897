"""MIP pyramids (port of rustracer_tpu/ops/mipmap.py: the wrap modes and
the host-side pyramid build).

The per-texture lookups (``lookup_trilinear``, ``lookup_ewa``,
``lookup_ewa_exact``) are not ported yet (ROADMAP.md, section A, item 13);
image textures are served through the shared atlas (scene/atlas.py).
"""
from __future__ import annotations

import numpy as np

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
