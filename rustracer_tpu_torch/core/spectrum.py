"""RGB helpers (port of rustracer_tpu/core/spectrum.py: luminance, is_black)."""
from __future__ import annotations

import numpy as np
import torch

# luminance weights: the Y row of the sRGB -> XYZ matrix, float32
LUM_WEIGHTS = tuple(float(w) for w in np.array(
    [0.212671, 0.715160, 0.072169], np.float32))


def luminance(rgb):
    w0, w1, w2 = LUM_WEIGHTS
    return rgb[..., 0] * w0 + rgb[..., 1] * w1 + rgb[..., 2] * w2


def is_black(rgb):
    return torch.all(rgb == 0.0, dim=-1)
