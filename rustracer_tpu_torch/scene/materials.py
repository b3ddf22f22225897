"""Materials (port of rustracer_tpu/scene/materials.py: the matte material
over constant, checkerboard and image textures, and the batched dispatch).

``MaterialSet.shade`` builds one (n_materials, M, ...) table from the
materials whose textures are all constant and gathers it by material id
(the parameter rows through hand kernel K8). Materials with a texture whose
value depends on the interaction (``is_constant`` False: checkerboards,
images) are evaluated per lane and written over their lanes; their image
textures are served by one atlas EWA lookup (hand kernel K5) per parameter
slot for the whole wavefront.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..ops.gather import row_gather
from . import atlas as A
from .textures import ImageTexture, UVMapping2D


class MatteMaterial:
    """Lambertian reflection with color kd."""

    def __init__(self, kd, sigma=None):
        if sigma is not None:
            raise NotImplementedError("Oren-Nayar (sigma) is not ported yet "
                                      "(ROADMAP.md, section A, item 13)")
        self.kd = kd

    def lobe_row(self, si, textures, atlas=None):
        """-> (type, params (..., 16), active (...)) of the material's one
        lobe: one row for constant textures, one per lane for images."""
        kd = torch.clamp(self.kd.evaluate(si, textures, atlas)
                         .to(torch.float32), min=0.0)
        params = torch.zeros(kd.shape[:-1] + (16,), dtype=torch.float32,
                             device=kd.device)
        params[..., 0:3] = kd
        return B.LAMBERTIAN_REFL, params, ~is_black(kd)


def _is_uniform(m) -> bool:
    """Every texture of ``m`` is constant: its lobe rows are the same on
    every lane."""
    return all(t.is_constant for t in vars(m).values())


def _atlas_eligible(t) -> bool:
    # max_aniso must equal the atlas's: another value would filter
    # differently than the per-texture lookup
    return (isinstance(t, ImageTexture)
            and isinstance(t.mapping, UVMapping2D)
            and not t.trilinear and t.max_aniso == A.MAX_ANISOTROPY
            and isinstance(t.scale, (int, float)))


class MaterialSet:
    """Material id -> material; ``shade`` is the batched dispatch.

    The atlas texel array is built on first use and kept for the
    ``textures["images"]`` list it was built from and the versions of its
    levels (a new list, or a level changed in place, rebuilds it; a list
    changed in place does not). With grad mode on and a level requiring
    grad it is built on every call instead, from the levels, so the
    lookups' gradient reaches them (``atlas.atlas_lookup_ewa_grad``)."""

    def __init__(self, materials: List[MatteMaterial] = None):
        self.materials = list(materials or [])
        self._atlas_info = None
        self._cache = {}

    def add(self, m: MatteMaterial) -> int:
        self.materials.append(m)
        self._atlas_info = None
        self._cache = {}
        return len(self.materials) - 1

    def atlas_prep(self):
        """Imagemap slots of the shared atlas: per material, its eligible
        ImageTexture attributes in attribute order become slots.
        -> (S, slot_tab (n_mat, S) int32 registration ids, registration
        tables (numpy), per-material texture lists)."""
        if self._atlas_info is not None:
            return self._atlas_info
        per_mat = [[t for t in vars(m).values() if _atlas_eligible(t)]
                   for m in self.materials]
        n_slots = max((len(t) for t in per_mat), default=0)
        if n_slots == 0:
            self._atlas_info = (0, None, None, per_mat)
            return self._atlas_info
        regs, reg_of = [], {}
        slot_tab = np.full((len(self.materials), n_slots), -1, np.int32)
        for mid, texs in enumerate(per_mat):
            for s, t in enumerate(texs):
                if id(t) not in reg_of:
                    reg_of[id(t)] = len(regs)
                    regs.append(t)
                slot_tab[mid, s] = reg_of[id(t)]
        self._atlas_info = (n_slots, slot_tab, A.build_registrations(regs),
                            per_mat)
        return self._atlas_info

    def _cached(self, key, source, build, version=None):
        """``build()`` once per ``source`` object (kept alive here, so its
        identity cannot be reused) and ``version``."""
        hit = self._cache.get(key)
        if hit is None or hit[0] is not source or hit[1] != version:
            hit = (source, version, build())
            self._cache[key] = hit
        return hit[2]

    def _uniform_table(self, textures, dev):
        """-> (types (n_mat,) int32, params (n_mat, 16), active (n_mat,))
        of the uniform materials; other rows are inactive zeros."""
        tab_t, tab_p, tab_a = [], [], []
        for m in self.materials:
            if _is_uniform(m):
                t, p, a = m.lobe_row(None, textures)
            else:
                t, p, a = (B.LAMBERTIAN_REFL,
                           torch.zeros(16, dtype=torch.float32),
                           torch.zeros((), dtype=torch.bool))
            tab_t.append(t)
            tab_p.append(p.to(dev))
            tab_a.append(a.to(dev))
        return (torch.tensor(tab_t, dtype=torch.int32, device=dev),
                torch.stack(tab_p).contiguous(), torch.stack(tab_a))

    def atlas_tables(self, textures, dev):
        """-> (quad, texels, registrations, slot_tab) on ``dev`` for the
        atlas lookups (quad: every registration wraps REPEAT, so texels are
        the (T, 12) quad rows, else the (T, 3) texels), or None when no
        material has an atlas slot or ``textures`` has no atlas."""
        n_slots, slot_tab, regs, _ = self.atlas_prep()
        if not n_slots or "atlas_meta" not in textures:
            return None
        quad = A.all_repeat(regs)
        images = textures["images"]
        texels = self._cached(
            ("texels", quad, dev), images,
            lambda: (A.atlas_quad_texels if quad else A.atlas_texels)(
                images).to(dev),
            [lv._version for pyr in images for lv in pyr])
        return (quad, texels) + self._regs_slots(regs, slot_tab, dev)

    def _regs_slots(self, regs, slot_tab, dev):
        regs_t = self._cached(("regs", dev), regs,
                              lambda: A.registrations_on(regs, dev))
        slots = self._cached(("slots", dev), slot_tab,
                             lambda: torch.as_tensor(slot_tab, device=dev))
        return regs_t, slots

    def _atlas_values(self, si, textures, midc):
        """One EWA lookup per slot -> {id(texture): (B, 3)} per material."""
        n_slots, slot_tab, regs, _ = self.atlas_prep()
        if not n_slots or "atlas_meta" not in textures:
            return None
        dev = si.t.device
        images = textures["images"]
        meta, levels = textures["atlas_meta"], textures["atlas_levels"]
        if torch.is_grad_enabled() and any(lv.requires_grad for pyr in images
                                           for lv in pyr):
            # built from the levels on every call: the graph reaches them
            texels = A.atlas_texels(images).to(dev)
            qidx = None
            if A.all_repeat(regs):
                qidx = self._cached(
                    ("quad_index", dev), None,
                    lambda: A.atlas_quad_index(images).to(dev),
                    [tuple(lv.shape) for pyr in images for lv in pyr])
            regs_t, slots = self._regs_slots(regs, slot_tab, dev)

            def lookup(reg):
                return A.atlas_lookup_ewa_grad(texels, qidx, meta, levels,
                                               regs_t, reg, si)
        else:
            quad, texels, regs_t, slots = self.atlas_tables(textures, dev)

            def lookup(reg):
                return A.atlas_lookup_ewa(texels, meta, levels, regs_t, reg,
                                          si, quad=quad)
        vals = [lookup(slots[midc, s].contiguous())
                for s in range(slots.shape[1])]
        return [{id(t): vals[s] for s, t in enumerate(texs)}
                for texs in self.atlas_prep()[3]]

    def shade(self, si, ctx):
        """-> (si, LobeStack) of every lane; lanes without a material or
        hit get inactive lobes. ``si`` comes back unchanged (its place is
        for bump mapping, which is not ported)."""
        textures = ctx.textures
        dev = si.t.device
        n_mat = len(self.materials)
        tab_t, tab_p, tab_a = self._uniform_table(textures, dev)
        midc = si.material.clamp(0, n_mat - 1)
        mid = midc.long()
        lt = tab_t[mid][:, None]
        lp = row_gather(tab_p, midc.int())[:, None, :]
        la = tab_a[mid][:, None]
        textured = [i for i, m in enumerate(self.materials)
                    if not _is_uniform(m)]
        if textured:
            atlas = self._atlas_values(si, textures, mid)
            for i in textured:
                sel = si.material == i
                t, p, a = self.materials[i].lobe_row(
                    si, textures, None if atlas is None else atlas[i])
                lt = torch.where(sel[:, None], t, lt)
                lp = torch.where(sel[:, None, None], p[:, None, :], lp)
                la = torch.where(sel[:, None], a[:, None], la)
        active = la & (si.material >= 0)[:, None] & si.valid[:, None]
        return si, B.LobeStack(type=lt, params=lp, active=active)
