"""Textures (port of rustracer_tpu/scene/textures.py: the constant texture)."""
from __future__ import annotations


class ConstantTexture:
    """Value lives in ``textures["const"][key]``, a (3,) tensor."""

    def __init__(self, key: str):
        self.key = key

    def evaluate(self, textures):
        return textures["const"][self.key]
