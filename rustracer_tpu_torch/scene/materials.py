"""Materials (port of rustracer_tpu/scene/materials.py: the matte material
over constant textures).

A material whose textures are all constant has the same lobe rows on every
lane, so ``MaterialSet.shade`` builds one (n_materials, M, ...) table from
the textures and gathers it by material id.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.spectrum import is_black
from ..ops import bsdf as B
from .textures import ConstantTexture


class MatteMaterial:
    """Lambertian reflection with color kd."""

    def __init__(self, kd: ConstantTexture, sigma=None):
        if sigma is not None:
            raise NotImplementedError("Oren-Nayar (sigma) is not ported yet "
                                      "(ROADMAP.md, section A, item 13)")
        self.kd = kd

    def lobe_row(self, textures):
        """-> (type, params (16,), active) of the material's one lobe."""
        kd = torch.clamp(self.kd.evaluate(textures).to(torch.float32),
                         min=0.0)
        params = torch.zeros(16, dtype=torch.float32, device=kd.device)
        params[0:3] = kd
        return B.LAMBERTIAN_REFL, params, ~is_black(kd)


class MaterialSet:
    """Material id -> material; ``shade`` is the batched dispatch."""

    def __init__(self, materials: List[MatteMaterial] = None):
        self.materials = list(materials or [])

    def add(self, m: MatteMaterial) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def shade(self, si, textures) -> B.LobeStack:
        """Lobe stack of every lane; lanes without a material or hit get
        inactive lobes."""
        rows = [m.lobe_row(textures) for m in self.materials]
        dev = si.t.device
        tab_t = torch.tensor([[r[0]] for r in rows], dtype=torch.int32,
                             device=dev)
        tab_p = torch.stack([r[1] for r in rows])[:, None, :].to(dev)
        tab_a = torch.stack([r[2] for r in rows])[:, None].to(dev)
        mid = si.material.clamp(0, len(rows) - 1).long()
        active = tab_a[mid] & (si.material >= 0)[:, None] & si.valid[:, None]
        return B.LobeStack(type=tab_t[mid], params=tab_p[mid], active=active)
