"""Textures (port of rustracer_tpu/scene/textures.py: the constant texture,
the UV mapping and the image texture served through the shared atlas).

A texture evaluates to a (3,) tensor (constant) or a per-lane (B, 3) tensor
(image). Image textures are looked up once per wavefront by
``MaterialSet.shade`` through the atlas (scene/atlas.py) and read here from
the ``atlas`` values it hands down; the per-texture lookups of
ops/mipmap.py are not ported yet.
"""
from __future__ import annotations

from ..ops.mipmap import WRAP_REPEAT


class ConstantTexture:
    """Value lives in ``textures["const"][key]``: a (3,) tensor (spectrum)
    or a 0-dim one (float)."""

    def __init__(self, key: str):
        self.key = key

    def evaluate(self, si, textures, atlas=None):
        return textures["const"][self.key]


class UVMapping2D:
    """st = (u * su + du, v * sv + dv)."""

    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = su, sv, du, dv


class ImageTexture:
    """Mip-mapped image texture; its pyramid is
    ``textures["images"][image_id]``."""

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
