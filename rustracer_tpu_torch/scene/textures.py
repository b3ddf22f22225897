"""Textures (port of rustracer_tpu/scene/textures.py): the constant, scale,
mix, UV, 2D checkerboard, fbm, wrinkled, windy, marble and image textures
over the UV and planar 2D mappings and the identity 3D mapping.

A texture evaluates to a (3,) tensor or a 0-dim one (constant) or a
per-lane (B, 3) or (B,) tensor (every other class); ``is_constant`` says
which, so a material knows whether its lobe is the same on every lane, and
``is_spectrum`` which shape. The classes broadcast floats against spectra
as the reference does.

An image texture's value comes from the shared atlas (scene/atlas.py)
where the reference's cache would hit: ``MaterialSet.shade`` hands each
material's textures a ``Lookups`` with the atlas values of the material's
own image textures, looked up at ``uv``; an image texture takes its value
there only when it is one of them and ``si.uv`` is that very tensor. Every
other evaluation (a texture the material does not hold directly, a
trilinear, planar or other-anisotropy image, a bump map's moved
evaluations) goes through the per-texture lookups of ops/mipmap.py (hand
kernel K17), on the texels the atlas already holds where ``Lookups``
carries them. The noise textures go through core/noise.py (hand kernel
K18).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.math import dot
from ..core.noise import fbm, turbulence
from ..core.transform import xform_point, xform_vector
from ..ops.mipmap import (WRAP_REPEAT, Texels, lookup_ewa, lookup_ewa_exact,
                          lookup_trilinear)


class Lookups(NamedTuple):
    """What ``MaterialSet.shade`` hands one material's textures."""
    values: dict                    # {id(ImageTexture): (B, 3)} atlas values
    uv: torch.Tensor                # the uv they were looked up at
    texels: Optional[torch.Tensor]  # the atlas's texel rows, for K17


def full(tex, v, si):
    """``tex``'s value ``v`` broadcast over the lanes of ``si``: (B, 3)
    for a spectrum, (B,) for a float."""
    n = si.t.shape[0]
    return v.expand(n, 3) if tex.is_spectrum else v.expand(n)


def _eval_full(tex, si, textures, atlas):
    return full(tex, tex.evaluate(si, textures, atlas), si)


def _spread(x):
    return torch.stack([x, x, x], -1)


# --- mappings ---

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


class PlanarMapping2D:
    """st = (ds + p . vs, dt + p . vt)."""

    def __init__(self, vs=(1, 0, 0), vt=(0, 1, 0), ds=0.0, dt=0.0):
        self.vs = np.asarray(vs, np.float32)
        self.vt = np.asarray(vt, np.float32)
        self.ds, self.dt = ds, dt

    def map(self, si):
        vs = torch.as_tensor(self.vs, device=si.p.device)
        vt = torch.as_tensor(self.vt, device=si.p.device)
        st = torch.stack([self.ds + dot(si.p, vs), self.dt + dot(si.p, vt)],
                         -1)
        dst0 = torch.stack([dot(si.dpdx, vs), dot(si.dpdx, vt)], -1)
        dst1 = torch.stack([dot(si.dpdy, vs), dot(si.dpdy, vt)], -1)
        return st, dst0, dst1


class IdentityMapping3D:
    """p, dpdx, dpdy in texture space: through the world-to-texture matrix
    (the inverse of the transform where the texture was declared), or as
    they are without one."""

    def __init__(self, world_to_texture=None):
        self.w2t = None if world_to_texture is None else \
            np.asarray(world_to_texture, np.float32)

    def map(self, si):
        if self.w2t is None:
            return si.p, si.dpdx, si.dpdy
        m = torch.as_tensor(self.w2t, device=si.p.device)
        return xform_point(m, si.p), xform_vector(m, si.dpdx), \
            xform_vector(m, si.dpdy)


# --- texture nodes ---

class ConstantTexture:
    """Value lives in ``textures["const"][key]``: a (3,) tensor (spectrum)
    or a 0-dim one (float)."""

    is_constant = True

    def __init__(self, key: str, is_spectrum=True):
        self.key = key
        self.is_spectrum = is_spectrum

    def evaluate(self, si, textures, atlas=None):
        return textures["const"][self.key]


class ScaleTexture:
    """tex1 * tex2; a spectrum where either is one."""

    is_constant = False

    def __init__(self, tex1, tex2):
        self.tex1, self.tex2 = tex1, tex2
        self.is_spectrum = tex1.is_spectrum or tex2.is_spectrum

    def evaluate(self, si, textures, atlas=None):
        a = _eval_full(self.tex1, si, textures, atlas)
        b = _eval_full(self.tex2, si, textures, atlas)
        if a.dim() < b.dim():
            a = a[:, None]
        if b.dim() < a.dim():
            b = b[:, None]
        return a * b


class MixTexture:
    """(1 - amount) * tex1 + amount * tex2, ``amount`` a float texture."""

    is_constant = False

    def __init__(self, tex1, tex2, amount):
        self.tex1, self.tex2, self.amount = tex1, tex2, amount
        self.is_spectrum = tex1.is_spectrum

    def evaluate(self, si, textures, atlas=None):
        t1 = _eval_full(self.tex1, si, textures, atlas)
        t2 = _eval_full(self.tex2, si, textures, atlas)
        amt = _eval_full(self.amount, si, textures, atlas)
        if t1.dim() > amt.dim():
            amt = amt[:, None]
        return (1.0 - amt) * t1 + amt * t2


class UVTexture:
    """(s - floor(s), t - floor(t), 0) of the mapping's st."""

    is_constant = False
    is_spectrum = True

    def __init__(self, mapping=None):
        self.mapping = mapping or UVMapping2D()

    def evaluate(self, si, textures, atlas=None):
        st, _, _ = self.mapping.map(si)
        s, t = st[:, 0], st[:, 1]
        return torch.stack([s - torch.floor(s), t - torch.floor(t),
                            torch.zeros_like(s)], -1)


def _bumpint(x):
    """The integral of the 1D check pattern up to x (PBRT's BumpInt)."""
    h = x / 2.0
    return torch.floor(h) + 2.0 * torch.clamp(h - torch.floor(h) - 0.5,
                                              min=0.0)


class CheckerboardTexture:
    """2D checkerboard (reference texture/checkerboard.rs): tex1 on the
    checks whose floor(s) + floor(t) is even, tex2 on the others, over any
    two textures. ``aa="closedform"`` box-filters the footprint of the
    texture differentials in closed form (the point value where the
    footprint stays inside one check, 0.5 where it spans more than one
    check's area); ``"none"`` point-samples."""

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


class _NoiseTexture:
    is_constant = False

    def __init__(self, mapping, is_spectrum):
        self.mapping = mapping or IdentityMapping3D()
        self.is_spectrum = is_spectrum

    def _out(self, v):
        return _spread(v) if self.is_spectrum else v


class FbmTexture(_NoiseTexture):
    """fbm of the mapped point, ``octaves`` at ``roughness`` (K18)."""

    def __init__(self, octaves=8, roughness=0.5, mapping=None,
                 is_spectrum=False):
        super().__init__(mapping, is_spectrum)
        self.octaves = int(octaves)
        self.roughness = float(roughness)

    def evaluate(self, si, textures, atlas=None):
        p, dpdx, dpdy = self.mapping.map(si)
        return self._out(fbm(p, dpdx, dpdy, self.roughness, self.octaves))


class WrinkledTexture(_NoiseTexture):
    """turbulence of the mapped point (K18)."""

    def __init__(self, octaves=8, roughness=0.5, mapping=None,
                 is_spectrum=False):
        super().__init__(mapping, is_spectrum)
        self.octaves = int(octaves)
        self.roughness = float(roughness)

    def evaluate(self, si, textures, atlas=None):
        p, dpdx, dpdy = self.mapping.map(si)
        return self._out(turbulence(p, dpdx, dpdy, self.roughness,
                                    self.octaves))


class WindyTexture(_NoiseTexture):
    """|fbm(0.1 p, 3 octaves)| * fbm(p, 6 octaves) (K18)."""

    def __init__(self, mapping=None, is_spectrum=False):
        super().__init__(mapping, is_spectrum)

    def evaluate(self, si, textures, atlas=None):
        p, dpdx, dpdy = self.mapping.map(si)
        wind = fbm(0.1 * p, 0.1 * dpdx, 0.1 * dpdy, 0.5, 3)
        wave = fbm(p, dpdx, dpdy, 0.5, 6)
        return self._out(torch.abs(wind) * wave)


_MARBLE_C0 = (0.58, 0.58, 0.6)
_MARBLE_C1 = (0.88, 0.85, 0.82)


class MarbleTexture(_NoiseTexture):
    """The reference's two-tone marble: 0.5 + 0.5 sin(p_y + variation *
    fbm(p)) of the scaled point between two colors (K18)."""

    def __init__(self, octaves=8, roughness=0.5, scale=1.0, variation=0.2,
                 mapping=None):
        super().__init__(mapping, True)
        self.octaves = int(octaves)
        self.roughness = float(roughness)
        self.scale = float(scale)
        self.variation = float(variation)

    def evaluate(self, si, textures, atlas=None):
        p, dpdx, dpdy = self.mapping.map(si)
        p = p * self.scale
        marble = p[:, 1] + self.variation * fbm(
            p, dpdx * self.scale, dpdy * self.scale, self.roughness,
            self.octaves)
        t = 0.5 + 0.5 * torch.sin(marble)
        c0 = torch.tensor(_MARBLE_C0, dtype=torch.float32, device=p.device)
        c1 = torch.tensor(_MARBLE_C1, dtype=torch.float32, device=p.device)
        return c0 + t[:, None] * (c1 - c0)


def image_texels(textures, image_id, atlas) -> Texels:
    """Image ``image_id``'s levels in the scene's texel rows, which
    ``atlas`` carries (``MaterialSet.lookups`` builds them once a scene)."""
    if atlas is None or atlas.texels is None or "atlas_meta" not in textures:
        raise ValueError("an image texture's per-texture lookup reads the "
                         "scene's texel rows: evaluate it with "
                         "MaterialSet.lookups(textures, device)")
    pyramid = textures["images"][image_id]
    meta = textures["atlas_meta"][image_id][:len(pyramid)]
    return Texels(atlas.texels, meta, int(pyramid[0].shape[-1]))


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
        """The atlas value where ``atlas`` holds this texture at ``si.uv``;
        else the reference's per-texture lookup: trilinear, the exact EWA
        above an anisotropy of 8, the 8-tap EWA otherwise (K17)."""
        if atlas is not None and si.uv is atlas.uv:
            v = atlas.values.get(id(self))
            if v is not None:
                return v if self.is_spectrum else v[:, 0]
        pyramid = image_texels(textures, self.image_id, atlas)
        st, dst0, dst1 = self.mapping.map(si)
        if self.trilinear:
            width = 2.0 * torch.maximum(torch.abs(dst0).max(-1).values,
                                        torch.abs(dst1).max(-1).values)
            v = lookup_trilinear(pyramid, st, width, self.wrap)
        elif self.max_aniso > 8.0:
            v = lookup_ewa_exact(pyramid, st, dst0, dst1, self.max_aniso,
                                 self.wrap)
        else:
            v = lookup_ewa(pyramid, st, dst0, dst1, self.max_aniso, self.wrap)
        v = v * self.scale
        if self.is_spectrum:
            return v.expand(-1, 3) if v.shape[1] == 1 else v
        return v[:, 0]


def image_textures(tex):
    """The ImageTextures ``tex`` evaluates, itself included."""
    if isinstance(tex, ImageTexture):
        yield tex
    for sub in ("tex1", "tex2", "amount"):
        if hasattr(tex, sub):
            yield from image_textures(getattr(tex, sub))
