"""Textures (port of rustracer_tpu/scene/textures.py: the constant texture,
the UV mapping, the 2D checkerboard and the image texture served through
the shared atlas).

A texture evaluates to a (3,) tensor (constant) or a per-lane (B, 3) tensor
(checkerboard, image); ``is_constant`` says which, so a material knows
whether its lobe is the same on every lane. Image textures are looked up
once per wavefront by ``MaterialSet.shade`` through the atlas
(scene/atlas.py) and read here from the ``atlas`` values it hands down; the
per-texture lookups of ops/mipmap.py are not ported yet.
"""
from __future__ import annotations

import torch

from ..ops.mipmap import WRAP_REPEAT


class ConstantTexture:
    """Value lives in ``textures["const"][key]``: a (3,) tensor (spectrum)
    or a 0-dim one (float)."""

    is_constant = True

    def __init__(self, key: str):
        self.key = key

    def evaluate(self, si, textures, atlas=None):
        return textures["const"][self.key]


class UVMapping2D:
    """st = (u * su + du, v * sv + dv)."""

    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = su, sv, du, dv

    def map(self, si):
        """-> (st, dst/dx, dst/dy), each (B, 2)."""
        st = torch.stack([si.uv[:, 0] * self.su + self.du,
                          si.uv[:, 1] * self.sv + self.dv], dim=-1)
        dst0 = torch.stack([si.dudx * self.su, si.dvdx * self.sv], dim=-1)
        dst1 = torch.stack([si.dudy * self.su, si.dvdy * self.sv], dim=-1)
        return st, dst0, dst1


def _bumpint(x):
    """The integral of the 1D check pattern up to x (PBRT's BumpInt)."""
    h = x / 2.0
    return torch.floor(h) + 2.0 * torch.clamp(h - torch.floor(h) - 0.5,
                                              min=0.0)


class CheckerboardTexture:
    """2D checkerboard (reference texture/checkerboard.rs, the JAX
    package's textures.py:128-171): tex1 on the checks whose floor(s) +
    floor(t) is even, tex2 on the others. ``aa="closedform"`` box-filters
    the footprint of the texture differentials in closed form (the point
    value where the footprint stays inside one check, 0.5 where it spans
    more than one check's area); ``"none"`` point-samples. tex1 and tex2
    give (3,) or (B, 3) values (spectrum) or 0-dim or (B,) ones (float)."""

    is_constant = False

    def __init__(self, tex1, tex2, mapping=None, aa="closedform",
                 is_spectrum=True):
        self.tex1, self.tex2 = tex1, tex2
        self.mapping = mapping or UVMapping2D()
        self.aa = aa
        self.is_spectrum = is_spectrum

    def evaluate(self, si, textures, atlas=None):
        st, dst0, dst1 = self.mapping.map(si)
        t1 = self.tex1.evaluate(si, textures, atlas)
        t2 = self.tex2.evaluate(si, textures, atlas)
        s, t = st[:, 0], st[:, 1]

        def lanes(x):
            return x[:, None] if self.is_spectrum else x

        even = lanes(torch.remainder(torch.floor(s) + torch.floor(t), 2.0)
                     == 0.0)
        point = torch.where(even, t1, t2)
        if self.aa == "none":
            return point
        ds = torch.maximum(torch.abs(dst0[:, 0]), torch.abs(dst1[:, 0]))
        dt = torch.maximum(torch.abs(dst0[:, 1]), torch.abs(dst1[:, 1]))
        s0, s1 = s - ds, s + ds
        t0, t1v = t - dt, t + dt
        inside = (torch.floor(s0) == torch.floor(s1)) \
            & (torch.floor(t0) == torch.floor(t1v))
        sint = (_bumpint(s1) - _bumpint(s0)) \
            / torch.clamp(2.0 * ds, min=1e-8)
        tint = (_bumpint(t1v) - _bumpint(t0)) \
            / torch.clamp(2.0 * dt, min=1e-8)
        area2 = sint + tint - 2.0 * sint * tint   # the share of tex2
        area2 = lanes(torch.where(ds * dt > 1.0, 0.5, area2))
        return torch.where(lanes(inside), point,
                           (1.0 - area2) * t1 + area2 * t2)


class ImageTexture:
    """Mip-mapped image texture; its pyramid is
    ``textures["images"][image_id]``."""

    is_constant = False

    def __init__(self, image_id, mapping=None, trilinear=False, max_aniso=8.0,
                 wrap=WRAP_REPEAT, scale=1.0, is_spectrum=True):
        self.image_id = image_id
        self.mapping = mapping or UVMapping2D()
        self.trilinear = trilinear
        self.max_aniso = max_aniso
        self.wrap = wrap
        self.scale = scale
        self.is_spectrum = is_spectrum

    def evaluate(self, si, textures, atlas=None):
        """The atlas lookup of this texture for the current wavefront
        (``atlas``: {id(texture): (B, 3)}, scale applied)."""
        v = None if atlas is None else atlas.get(id(self))
        if v is None:
            raise NotImplementedError(
                "image textures outside the shared atlas (trilinear, "
                "max_aniso != 8, non-UV mappings, textured scale) need the "
                "per-texture mipmap lookups, not ported yet (ROADMAP.md, "
                "section A, item 13)")
        return v if self.is_spectrum else v[:, 0]
