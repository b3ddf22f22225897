"""Reconstruction filters (port of rustracer_tpu/render/filters.py): box,
triangle, Gaussian and Mitchell-Netravali, and ``make_filter`` with the
reference's sinc -> Mitchell mapping.

``evaluate`` is the plain version of the weight that hand kernels K4 and
K9 compute (csrc/filter.cuh): every multiply and add in the reference's
order, each Python constant rounded to float32 where the reference's
rounds it (a weakly typed scalar meeting a float32 array)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# filter kind -> the code K4 and K9 take (csrc/filter.cuh)
KINDS = {"box": 0, "triangle": 1, "gaussian": 2, "mitchell": 3}


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Filter:
    kind: str = "box"          # box | triangle | gaussian | mitchell
    xwidth: float = 0.5
    ywidth: float = 0.5
    alpha: float = 2.0         # gaussian
    b: float = 1.0 / 3.0       # mitchell
    c: float = 1.0 / 3.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown filter kind {self.kind}")

    @property
    def radius(self):
        return (self.xwidth, self.ywidth)

    def _gauss_expv(self, r):
        # the reference's np.exp in float64, rounded where it meets float32
        return _f32(np.exp(-self.alpha * r * r))

    def mitchell_coeffs(self):
        """(i3, i2, i0, o3, o2, o1, o0): the polynomial coefficients of
        Mitchell's inner (|x| <= 1) and outer (1 < |x| <= 2) pieces,
        computed in float64 and rounded to float32 as the reference's."""
        b, c = self.b, self.c
        return tuple(_f32(v) for v in (
            12.0 - 9.0 * b - 6.0 * c, -18.0 + 12.0 * b + 6.0 * c,
            6.0 - 2.0 * b, -b - 6.0 * c, 6.0 * b + 30.0 * c,
            -12.0 * b - 48.0 * c, 8.0 * b + 24.0 * c))

    def kernel_params(self):
        """-> (kind code, 8 float32 parameters) as K4 and K9 take them:
        Gaussian (-alpha, expv_x, expv_y), Mitchell ``mitchell_coeffs``."""
        p = [0.0] * 8
        if self.kind == "gaussian":
            p[:3] = (_f32(-self.alpha), self._gauss_expv(self.xwidth),
                     self._gauss_expv(self.ywidth))
        elif self.kind == "mitchell":
            p[:7] = self.mitchell_coeffs()
        return KINDS[self.kind], p

    def axis_weights(self, dx, dy):
        """Each axis's 1-D factor of the weight and whether the offset lies
        inside the extent -> (wx, mx, wy, my): the plain twin of K4's
        separable weights (csrc/film.cu), which ``evaluate`` multiplies."""
        xw, yw = _f32(self.xwidth), _f32(self.ywidth)
        if self.kind == "box":
            fx, fy = torch.ones_like(dx), torch.ones_like(dy)
        elif self.kind == "triangle":
            fx = torch.clamp(xw - torch.abs(dx), min=0.0)
            fy = torch.clamp(yw - torch.abs(dy), min=0.0)
        elif self.kind == "gaussian":
            na = _f32(-self.alpha)
            fx = torch.clamp(torch.exp(na * dx * dx)
                             - self._gauss_expv(self.xwidth), min=0.0)
            fy = torch.clamp(torch.exp(na * dy * dy)
                             - self._gauss_expv(self.ywidth), min=0.0)
        else:
            fx, fy = self._mitchell_1d(dx / xw), self._mitchell_1d(dy / yw)
        return fx, torch.abs(dx) <= xw, fy, torch.abs(dy) <= yw

    def _mitchell_1d(self, x):
        i3, i2, i0, o3, o2, o1, o0 = self.mitchell_coeffs()
        sixth = _f32(1.0 / 6.0)
        x = torch.abs(2.0 * x)
        x2 = x * x
        x3 = x2 * x
        inner = (i3 * x3 + i2 * x2 + i0) * sixth
        outer = (o3 * x3 + o2 * x2 + o1 * x + o0) * sixth
        return torch.where(x > 1.0, torch.where(x > 2.0, 0.0, outer), inner)

    def evaluate(self, dx, dy):
        """Filter weight at offset (dx, dy) from the sample point: the
        product of the two axes' factors inside the extent, else 0."""
        fx, mx, fy, my = self.axis_weights(dx, dy)
        return torch.where(mx & my, fx * fy, 0.0).to(torch.float32)


def make_filter(name, params=None):
    """The filter a scene's PixelFilter names, with PBRT's defaults."""
    from ..scene.paramset import ParamSet
    ps = params or ParamSet()
    if name == "box":
        return Filter("box", ps.find_one_float("xwidth", 0.5),
                      ps.find_one_float("ywidth", 0.5))
    if name == "triangle":
        return Filter("triangle", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0))
    if name == "gaussian":
        return Filter("gaussian", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0),
                      alpha=ps.find_one_float("alpha", 2.0))
    if name == "mitchell":
        return Filter("mitchell", ps.find_one_float("xwidth", 2.0),
                      ps.find_one_float("ywidth", 2.0),
                      b=ps.find_one_float("B", 1.0 / 3.0),
                      c=ps.find_one_float("C", 1.0 / 3.0))
    if name == "sinc":
        # as the reference: the Lanczos sinc is approximated by Mitchell
        return Filter("mitchell", ps.find_one_float("xwidth", 4.0),
                      ps.find_one_float("ywidth", 4.0))
    raise ValueError(f"unknown filter {name!r}")
