"""Materials (port of rustracer_tpu/scene/materials.py: matte with its
Oren-Nayar sigma, plastic, mirror, glass (smooth and rough), metal,
substrate, translucent, uber, Disney (thin too), Fourier and mix over any
texture, bump mapping, and the batched dispatch).

A material's ``lobe_rows`` gives its lobes as (type, params (..., 16),
active) rows in the reference's slot layout; the number of rows is
structural (``n_rows``). ``MaterialSet.shade`` builds one (n_materials,
M * 16) parameter table from the materials whose textures are all constant
and that have no bump map, and gathers it by material id (hand kernel K8),
with the (n_materials, M) types and active flags and the (n_materials,)
eta beside it. Every other material (a texture whose value depends on the
interaction, or a bump map) is evaluated per lane and written over its
lanes, its bump map first (``Material.apply_bump``: the shading frame of
its lanes comes back bumped). The image textures a material holds
directly (UV-mapped, 8:1 anisotropy) are served by one atlas EWA lookup
(hand kernel K5) per parameter slot for the whole wavefront; every other
image evaluation takes the per-texture lookups (hand kernel K17). With
grad mode on and a pyramid level requiring grad, both read texel rows
built from the levels on every call, and their gradients (K10, K20) reach
the levels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core.interaction import make_shading_frame
from ..core.math import cross, dot, normalize
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..ops.fresnel import FR_DISNEY
from ..ops.gather import row_gather
from ..ops.microfacet import TROWBRIDGE, roughness_to_alpha
from . import atlas as A
from .textures import ImageTexture, Lookups, UVMapping2D, image_textures

_DEG2RAD = float(np.float32(np.pi / 180.0))


def _levels_require_grad(textures) -> bool:
    """Grad mode is on and a pyramid level of ``textures`` requires grad."""
    return torch.is_grad_enabled() and any(
        lv.requires_grad for pyr in textures["images"] for lv in pyr)


def _mk_params(bs, dev, pa=None, pb=None, pc=None, **slots):
    """(*bs, 16) params: the colors pa, pb, pc in [0:3], [3:6], [6:9] and
    the scalars s0..s6 in [9..15]; the rest 0."""
    p = torch.zeros(bs + (16,), dtype=torch.float32, device=dev)
    for i, c in enumerate((pa, pb, pc)):
        if c is not None:
            p[..., 3 * i:3 * i + 3] = c
    for name, v in slots.items():
        p[..., 9 + int(name[1])] = v
    return p


def _lanes(si):
    return () if si is None else tuple(si.t.shape)


class Material:
    """A material: its lobe rows, the lobe types they can take, the
    relative IOR of the lanes it shades (None: 1) and its bump map (a float
    texture, or None)."""
    n_rows = 1
    bump_tex = None

    def lobe_rows(self, si, textures, atlas=None) -> List[tuple]:
        raise NotImplementedError

    def lobe_types(self) -> set:
        raise NotImplementedError

    def eta_value(self, si, textures, atlas=None):
        return None

    def apply_bump(self, si, textures, atlas=None):
        """``si`` with the shading frame of the bump map (finite
        differences of the displacement at the hit and at the hit moved by
        du along dpdu and by dv along dpdv, each half the sum of |du/dx|
        and |du/dy| or 0.0005 where that is 0; the normal flipped to the
        side of ``si.n``); ``si`` itself without a bump map."""
        d = self.bump_tex
        if d is None:
            return si
        du = 0.5 * (torch.abs(si.dudx) + torch.abs(si.dudy))
        du = torch.where(du == 0.0, 0.0005, du)
        dv = 0.5 * (torch.abs(si.dvdx) + torch.abs(si.dvdy))
        dv = torch.where(dv == 0.0, 0.0005, dv)
        zero = torch.zeros_like(du)
        si_u = dataclasses.replace(si, p=si.p + du[:, None] * si.dpdu,
                                   uv=si.uv + torch.stack([du, zero], -1))
        si_v = dataclasses.replace(si, p=si.p + dv[:, None] * si.dpdv,
                                   uv=si.uv + torch.stack([zero, dv], -1))
        disp = d.evaluate(si, textures, atlas)
        disp_u = d.evaluate(si_u, textures, atlas)
        disp_v = d.evaluate(si_v, textures, atlas)
        dddu = (disp_u - disp) / du
        dddv = (disp_v - disp) / dv
        dpdu = si.dpdu + dddu[:, None] * si.ns
        dpdv = si.dpdv + dddv[:, None] * si.ns
        ns = normalize(cross(dpdu, dpdv))
        ns = torch.where((dot(ns, si.n) < 0.0)[:, None], -ns, ns)
        ss, ts = make_shading_frame(ns, dpdu)
        return dataclasses.replace(si, ns=ns, ss=ss, ts=ts)


def _color(tex, si, textures, atlas):
    return torch.clamp(tex.evaluate(si, textures, atlas).to(torch.float32),
                       min=0.0)


class MatteMaterial(Material):
    """Lambertian reflection with color kd, or Oren-Nayar where the
    texture sigma (degrees) is not 0; sigma None is the Lambertian lobe."""

    def __init__(self, kd, sigma=None, bump=None):
        self.kd = kd
        self.sigma = sigma
        self.bump_tex = bump

    def lobe_types(self):
        return {B.LAMBERTIAN_REFL} if self.sigma is None \
            else {B.LAMBERTIAN_REFL, B.OREN_NAYAR}

    def lobe_rows(self, si, textures, atlas=None):
        kd = _color(self.kd, si, textures, atlas)
        bs, dev = _lanes(si), kd.device
        if self.sigma is None:
            return [(B.LAMBERTIAN_REFL, _mk_params(bs, dev, pa=kd),
                     ~is_black(kd))]
        sigma = torch.clamp(self.sigma.evaluate(si, textures, atlas), 0.0,
                            90.0)
        sig_rad = sigma * _DEG2RAD
        s2 = sig_rad * sig_rad
        a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b = 0.45 * s2 / (s2 + 0.09)
        ltype = torch.where(sigma == 0.0, B.LAMBERTIAN_REFL,
                            B.OREN_NAYAR).to(torch.int32)
        return [(ltype, _mk_params(bs, dev, pa=kd, s5=a, s6=b),
                 ~is_black(kd))]


class PlasticMaterial(Material):
    """Lambertian kd under a Trowbridge-Reitz microfacet ks (eta 1.5)."""
    n_rows = 2

    def __init__(self, kd, ks, roughness, remap_roughness=True, bump=None):
        self.kd, self.ks, self.roughness = kd, ks, roughness
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.LAMBERTIAN_REFL, B.MICROFACET_REFL}

    def lobe_rows(self, si, textures, atlas=None):
        kd = _color(self.kd, si, textures, atlas)
        ks = _color(self.ks, si, textures, atlas)
        bs, dev = _lanes(si), kd.device
        rough = self.roughness.evaluate(si, textures, atlas)
        alpha = roughness_to_alpha(rough) if self.remap else rough
        return [(B.LAMBERTIAN_REFL, _mk_params(bs, dev, pa=kd),
                 ~is_black(kd)),
                (B.MICROFACET_REFL,
                 _mk_params(bs, dev, pa=ks, s0=1.5, s1=alpha, s2=alpha,
                            s3=float(TROWBRIDGE), s4=1.0),
                 ~is_black(ks))]


class MirrorMaterial(Material):
    """Perfect specular reflection kr, no Fresnel."""

    def __init__(self, kr, bump=None):
        self.kr = kr
        self.bump_tex = bump

    def lobe_types(self):
        return {B.SPECULAR_REFL}

    def lobe_rows(self, si, textures, atlas=None):
        kr = _color(self.kr, si, textures, atlas)
        return [(B.SPECULAR_REFL, _mk_params(_lanes(si), kr.device, pa=kr,
                                             s4=0.0), ~is_black(kr))]


class GlassMaterial(Material):
    """Dielectric: specular reflection and transmission (FRESNEL_SPECULAR)
    where both roughnesses are 0, else Trowbridge-Reitz microfacet
    reflection and transmission."""
    n_rows = 2

    def __init__(self, kr, kt, index, urough=None, vrough=None,
                 remap_roughness=True, bump=None):
        self.kr, self.kt, self.index = kr, kt, index
        self.urough, self.vrough = urough, vrough
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.FRESNEL_SPECULAR, B.MICROFACET_REFL, B.MICROFACET_TRANS}

    def eta_value(self, si, textures, atlas=None):
        return torch.broadcast_to(self.index.evaluate(si, textures, atlas),
                                  _lanes(si))

    def lobe_rows(self, si, textures, atlas=None):
        kr = _color(self.kr, si, textures, atlas)
        kt = _color(self.kt, si, textures, atlas)
        bs, dev = _lanes(si), kr.device
        eta = self.index.evaluate(si, textures, atlas)
        if self.urough is None:
            urough = vrough = torch.zeros(bs, device=dev)
        else:
            urough = self.urough.evaluate(si, textures, atlas)
            vrough = self.vrough.evaluate(si, textures, atlas)
        smooth = (urough == 0.0) & (vrough == 0.0)
        ax = roughness_to_alpha(urough) if self.remap else urough
        ay = roughness_to_alpha(vrough) if self.remap else vrough
        row1_type = torch.where(smooth, B.FRESNEL_SPECULAR,
                                B.MICROFACET_REFL).to(torch.int32)
        return [(row1_type,
                 _mk_params(bs, dev, pa=kr, pb=kt, s0=eta, s1=ax, s2=ay,
                            s3=float(TROWBRIDGE), s4=1.0),
                 ~(is_black(kr) & is_black(kt))),
                (B.MICROFACET_TRANS,
                 _mk_params(bs, dev, pa=kt, s0=eta, s1=ax, s2=ay,
                            s3=float(TROWBRIDGE)),
                 (~smooth) & ~is_black(kt))]


class MetalMaterial(Material):
    """Conductor Trowbridge-Reitz microfacet with RGB eta and k."""

    def __init__(self, eta, k, roughness, urough=None, vrough=None,
                 remap_roughness=True, bump=None):
        self.eta, self.k = eta, k
        self.roughness = roughness
        self.urough, self.vrough = urough, vrough
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.MICROFACET_REFL}

    def lobe_rows(self, si, textures, atlas=None):
        eta = self.eta.evaluate(si, textures, atlas)
        k = self.k.evaluate(si, textures, atlas)
        bs, dev = _lanes(si), eta.device
        ur = (self.urough or self.roughness).evaluate(si, textures, atlas)
        vr = (self.vrough or self.roughness).evaluate(si, textures, atlas)
        ax = roughness_to_alpha(ur) if self.remap else ur
        ay = roughness_to_alpha(vr) if self.remap else vr
        return [(B.MICROFACET_REFL,
                 _mk_params(bs, dev, pa=1.0, pb=eta, pc=k, s1=ax, s2=ay,
                            s3=float(TROWBRIDGE), s4=2.0),
                 torch.ones(bs, dtype=torch.bool, device=dev))]


class SubstrateMaterial(Material):
    """Ashikhmin-Shirley's FresnelBlend: diffuse kd under glossy ks."""

    def __init__(self, kd, ks, urough, vrough, remap_roughness=True,
                 bump=None):
        self.kd, self.ks = kd, ks
        self.urough, self.vrough = urough, vrough
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.FRESNEL_BLEND}

    def lobe_rows(self, si, textures, atlas=None):
        kd = _color(self.kd, si, textures, atlas)
        ks = _color(self.ks, si, textures, atlas)
        ur = self.urough.evaluate(si, textures, atlas)
        vr = self.vrough.evaluate(si, textures, atlas)
        ax = roughness_to_alpha(ur) if self.remap else ur
        ay = roughness_to_alpha(vr) if self.remap else vr
        return [(B.FRESNEL_BLEND,
                 _mk_params(_lanes(si), kd.device, pa=kd, pb=ks, s1=ax,
                            s2=ay, s3=float(TROWBRIDGE)),
                 ~(is_black(kd) & is_black(ks)))]


class TranslucentMaterial(Material):
    """Diffuse and glossy lobes split between reflection (``reflect``) and
    transmission (``transmit``), eta 1.5."""
    n_rows = 4

    def __init__(self, kd, ks, roughness, reflect, transmit,
                 remap_roughness=True, bump=None):
        self.kd, self.ks, self.roughness = kd, ks, roughness
        self.reflect, self.transmit = reflect, transmit
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.LAMBERTIAN_REFL, B.LAMBERTIAN_TRANS, B.MICROFACET_REFL,
                B.MICROFACET_TRANS}

    def lobe_rows(self, si, textures, atlas=None):
        kd = _color(self.kd, si, textures, atlas)
        ks = _color(self.ks, si, textures, atlas)
        r = _color(self.reflect, si, textures, atlas)
        t = _color(self.transmit, si, textures, atlas)
        bs, dev = _lanes(si), kd.device
        rough = self.roughness.evaluate(si, textures, atlas)
        alpha = roughness_to_alpha(rough) if self.remap else rough
        return [(B.LAMBERTIAN_REFL, _mk_params(bs, dev, pa=kd * r),
                 ~is_black(kd * r)),
                (B.LAMBERTIAN_TRANS, _mk_params(bs, dev, pa=kd * t),
                 ~is_black(kd * t)),
                (B.MICROFACET_REFL,
                 _mk_params(bs, dev, pa=ks * r, s0=1.5, s1=alpha, s2=alpha,
                            s3=float(TROWBRIDGE), s4=1.0),
                 ~is_black(ks * r)),
                (B.MICROFACET_TRANS,
                 _mk_params(bs, dev, pa=ks * t, s0=1.5, s1=alpha, s2=alpha,
                            s3=float(TROWBRIDGE)),
                 ~is_black(ks * t))]


class UberMaterial(Material):
    """Diffuse kd, glossy ks, specular kr and kt behind an opacity whose
    complement passes straight through (a SPECULAR_TRANS row of eta 1 in
    slot 9; the lane's eta, which eta_scale reads, stays ``eta``)."""
    n_rows = 5

    def __init__(self, kd, ks, kr, kt, roughness, urough=None, vrough=None,
                 opacity=None, eta=None, remap_roughness=True, bump=None):
        self.kd, self.ks, self.kr, self.kt = kd, ks, kr, kt
        self.roughness = roughness
        self.urough, self.vrough = urough, vrough
        self.opacity = opacity
        self.eta = eta
        self.remap = remap_roughness
        self.bump_tex = bump

    def lobe_types(self):
        return {B.SPECULAR_TRANS, B.LAMBERTIAN_REFL, B.MICROFACET_REFL,
                B.SPECULAR_REFL}

    def eta_value(self, si, textures, atlas=None):
        if self.eta is None:
            return torch.full(_lanes(si), 1.5, device=None if si is None
                              else si.t.device)
        return torch.broadcast_to(self.eta.evaluate(si, textures, atlas),
                                  _lanes(si))

    def lobe_rows(self, si, textures, atlas=None):
        kd = _color(self.kd, si, textures, atlas)
        ks = _color(self.ks, si, textures, atlas)
        kr = _color(self.kr, si, textures, atlas)
        kt = _color(self.kt, si, textures, atlas)
        bs, dev = _lanes(si), kd.device
        op = torch.clamp(self.opacity.evaluate(si, textures, atlas), 0.0,
                         1.0) if self.opacity is not None \
            else torch.ones(bs + (3,), device=dev)
        eta = self.eta_value(si, textures, atlas).to(dev)
        ur = (self.urough or self.roughness).evaluate(si, textures, atlas)
        vr = (self.vrough or self.roughness).evaluate(si, textures, atlas)
        ax = roughness_to_alpha(ur) if self.remap else ur
        ay = roughness_to_alpha(vr) if self.remap else vr
        one_m_op = 1.0 - op
        return [(B.SPECULAR_TRANS, _mk_params(bs, dev, pa=one_m_op, s0=1.0),
                 ~is_black(one_m_op)),
                (B.LAMBERTIAN_REFL, _mk_params(bs, dev, pa=op * kd),
                 ~is_black(op * kd)),
                (B.MICROFACET_REFL,
                 _mk_params(bs, dev, pa=op * ks, s0=eta, s1=ax, s2=ay,
                            s3=float(TROWBRIDGE), s4=1.0),
                 ~is_black(op * ks)),
                (B.SPECULAR_REFL,
                 _mk_params(bs, dev, pa=op * kr, s0=eta, s4=1.0),
                 ~is_black(op * kr)),
                (B.SPECULAR_TRANS, _mk_params(bs, dev, pa=op * kt, s0=eta),
                 ~is_black(op * kt))]


# the luminance of a linear RGB color
_LUMINANCE = (0.212671, 0.715160, 0.072169)


class DisneyMaterial(Material):
    """Disney's principled BSDF without its subsurface lobe, as the
    reference: diffuse, retro-reflection, sheen, a Trowbridge-Reitz
    specular with the Disney Fresnel, clearcoat and specular transmission;
    ``thin`` adds the fake subsurface lobe and diffuse transmission."""

    def __init__(self, color, metallic, eta, roughness, specular_tint,
                 anisotropic, sheen, sheen_tint, clearcoat, clearcoat_gloss,
                 spec_trans, flatness=None, diff_trans=None, thin=False,
                 bump=None):
        self.color, self.metallic, self.eta = color, metallic, eta
        self.roughness = roughness
        self.specular_tint, self.anisotropic = specular_tint, anisotropic
        self.sheen, self.sheen_tint = sheen, sheen_tint
        self.clearcoat, self.clearcoat_gloss = clearcoat, clearcoat_gloss
        self.spec_trans = spec_trans
        self.flatness, self.diff_trans = flatness, diff_trans
        self.thin = thin
        self.bump_tex = bump

    @property
    def n_rows(self):
        return 8 if self.thin else 6

    def lobe_types(self):
        t = {B.DISNEY_DIFFUSE, B.DISNEY_RETRO, B.DISNEY_SHEEN,
             B.MICROFACET_REFL, B.DISNEY_CLEARCOAT, B.MICROFACET_TRANS}
        if self.thin:
            t |= {B.DISNEY_FAKE_SS, B.LAMBERTIAN_TRANS}
        return t

    def eta_value(self, si, textures, atlas=None):
        return torch.broadcast_to(self.eta.evaluate(si, textures, atlas),
                                  _lanes(si))

    def lobe_rows(self, si, textures, atlas=None):
        def ev(tex):
            return tex.evaluate(si, textures, atlas)

        c = _color(self.color, si, textures, atlas)
        bs, dev = _lanes(si), c.device
        zeros = torch.zeros(bs, device=dev)
        metallic = ev(self.metallic)
        eta = ev(self.eta)
        strans = ev(self.spec_trans)
        rough = ev(self.roughness)
        dt = ev(self.diff_trans) / 2.0 if self.diff_trans is not None \
            else zeros
        diff_weight = (1.0 - metallic) * (1.0 - strans)
        lum = c[..., 0] * _LUMINANCE[0] + c[..., 1] * _LUMINANCE[1] \
            + c[..., 2] * _LUMINANCE[2]
        ctint = torch.where(lum[..., None] > 0.0,
                            c / torch.clamp(lum[..., None], min=1e-8), 1.0)
        sheen_w = ev(self.sheen)
        stint = ev(self.sheen_tint)
        csheen = (1.0 - stint)[..., None] + stint[..., None] * ctint
        if self.thin:
            flat = ev(self.flatness) if self.flatness is not None else zeros
            diff_scale = diff_weight * (1.0 - flat) * (1.0 - dt)
            ss_scale = diff_weight * flat * (1.0 - dt)
        else:
            diff_scale = diff_weight
        aniso = ev(self.anisotropic)
        aspect = torch.sqrt(torch.clamp(1.0 - 0.9 * aniso, min=1e-4))
        ax = torch.clamp(rough * rough / aspect, min=1e-3)
        ay = torch.clamp(rough * rough * aspect, min=1e-3)
        # cspec0, the Disney Fresnel's color at normal incidence
        spec_tint = ev(self.specular_tint)
        r0_eta = (eta - 1.0) / (eta + 1.0)
        r0_eta = r0_eta * r0_eta
        cspec0 = (1.0 - metallic[..., None]) * r0_eta[..., None] \
            * ((1.0 - spec_tint)[..., None] + spec_tint[..., None] * ctint) \
            + metallic[..., None] * c
        cc = ev(self.clearcoat)
        gloss = ev(self.clearcoat_gloss)
        gloss = (1.0 - gloss) * 0.1 + gloss * 0.001
        diffuse = diff_weight > 0.0
        rows = [(B.DISNEY_DIFFUSE,
                 _mk_params(bs, dev, pa=diff_scale[..., None] * c), diffuse),
                (B.DISNEY_RETRO,
                 _mk_params(bs, dev, pa=diff_scale[..., None] * c, s5=rough),
                 diffuse),
                (B.DISNEY_SHEEN,
                 _mk_params(bs, dev,
                            pa=(diff_weight * sheen_w)[..., None] * csheen),
                 (diff_weight * sheen_w) > 0.0),
                (B.MICROFACET_REFL,
                 _mk_params(bs, dev, pa=1.0, pc=cspec0, s0=eta, s1=ax, s2=ay,
                            s3=float(TROWBRIDGE), s4=float(FR_DISNEY),
                            s5=metallic),
                 torch.ones(bs, dtype=torch.bool, device=dev)),
                (B.DISNEY_CLEARCOAT,
                 _mk_params(bs, dev, pa=cc[..., None], s6=gloss), cc > 0.0),
                (B.MICROFACET_TRANS,
                 _mk_params(bs, dev, pa=strans[..., None] * torch.sqrt(
                     torch.clamp(c, min=0.0)), s0=eta, s1=ax, s2=ay,
                     s3=float(TROWBRIDGE)),
                 strans > 0.0)]
        if self.thin:
            rows += [(B.DISNEY_FAKE_SS,
                      _mk_params(bs, dev, pa=ss_scale[..., None] * c,
                                 s5=rough), ss_scale > 0.0),
                     (B.LAMBERTIAN_TRANS,
                      _mk_params(bs, dev, pa=dt[..., None] * c), dt > 0.0)]
        return rows


class FourierMaterial(Material):
    """A measured BSDF from a .bsdf table (ops/fourier.py): one FOURIER
    lobe whose slot 15 holds the table's id in the scene's table set
    (``textures["fourier"]``), eta the table's."""

    def __init__(self, table_id: int, eta: float = 1.0, bump=None):
        self.table_id = int(table_id)
        self.eta = float(eta)
        self.bump_tex = bump

    def lobe_types(self):
        return {B.FOURIER}

    def eta_value(self, si, textures, atlas=None):
        return torch.full(_lanes(si), self.eta, device=None if si is None
                          else si.t.device)

    def lobe_rows(self, si, textures, atlas=None):
        bs = _lanes(si)
        dev = None if si is None else si.t.device
        return [(B.FOURIER, _mk_params(bs, dev, s0=self.eta,
                                       s6=float(self.table_id)),
                 torch.ones(bs, dtype=torch.bool, device=dev))]


class MixMaterial(Material):
    """Two materials' rows: ``m1``'s colors (slots 0:3 and 3:6) scaled by
    ``amount`` and ``m2``'s by 1 - amount; a row stays active where some
    channel of its weight is above 0. The lane's eta is ``m1``'s.

    The sub-materials are shaded on the lanes the mix shades, without their
    bump maps, as the reference does; only the mix's own textures are atlas
    slots, so their image textures take the per-texture lookups (K17)."""

    def __init__(self, m1: Material, m2: Material, amount):
        self.m1, self.m2, self.amount = m1, m2, amount

    @property
    def n_rows(self):
        return self.m1.n_rows + self.m2.n_rows

    def lobe_types(self):
        return self.m1.lobe_types() | self.m2.lobe_types()

    def eta_value(self, si, textures, atlas=None):
        return self.m1.eta_value(si, textures, atlas)

    def lobe_rows(self, si, textures, atlas=None):
        amt = torch.clamp(self.amount.evaluate(si, textures, atlas), 0.0, 1.0)

        def scale(rows, w):
            on = (w > 0.0).any(-1)
            return [(t, torch.cat([p[..., 0:3] * w, p[..., 3:6] * w,
                                   p[..., 6:]], -1), a & on)
                    for t, p, a in rows]

        return scale(self.m1.lobe_rows(si, textures, atlas), amt) \
            + scale(self.m2.lobe_rows(si, textures, atlas), 1.0 - amt)


def _parts(m):
    """-> (the textures ``m`` holds directly, its bump map aside; the
    materials it holds)."""
    tex, mats = [], []
    for k, v in vars(m).items():
        if isinstance(v, Material):
            mats.append(v)
        elif hasattr(v, "evaluate") and k != "bump_tex":
            tex.append(v)
    return tex, mats


def _is_uniform(m) -> bool:
    """``m`` has no bump map and every texture of it and of the materials
    it holds is constant: its lobe rows are the same on every lane."""
    tex, mats = _parts(m)
    return m.bump_tex is None and all(t.is_constant for t in tex) \
        and all(_is_uniform(x) for x in mats)


def _per_texture_images(m, held=False):
    """The image textures that shading ``m`` looks up per texture (K17):
    any not held directly or not atlas-eligible, any inside a bump map
    (its moved evaluations), all of a material held by a mix (``held``:
    without its bump map, which the mix does not apply)."""
    tex, mats = _parts(m)
    out = [i for t in tex for i in image_textures(t)
           if held or i is not t or not _atlas_eligible(i)]
    if m.bump_tex is not None and not held:
        out += list(image_textures(m.bump_tex))
    for x in mats:
        out += _per_texture_images(x, True)
    return out


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
    lookups' gradient reaches them (``atlas.atlas_lookup_ewa_grad``, and
    ops/mipmap.py's lookups through K20)."""

    def __init__(self, materials: List[Material] = None):
        self.materials = list(materials or [])
        self._atlas_info = None
        self._cache = {}

    def add(self, m: Material) -> int:
        self.materials.append(m)
        self._atlas_info = None
        self._cache = {}
        return len(self.materials) - 1

    def per_texture_images(self) -> list:
        """The image textures some material looks up per texture (K17),
        outside the atlas slots."""
        return [t for m in self.materials for t in _per_texture_images(m)]

    @property
    def max_lobes(self) -> int:
        """M: the most lobe rows of any material (at least 1)."""
        return max([1] + [m.n_rows for m in self.materials])

    def types_present(self) -> Tuple[int, ...]:
        """The lobe types the scene's materials can take, sorted."""
        s = set()
        for m in self.materials:
            s |= m.lobe_types()
        return tuple(sorted(s)) or (B.LAMBERTIAN_REFL,)

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
        """-> (types (n_mat, M) int32, params (n_mat, M * 16), active
        (n_mat, M), eta (n_mat,) or None where every eta is 1) of the
        uniform materials; other rows and the padding are inactive zeros."""
        M = self.max_lobes
        zero_p = torch.zeros(16, dtype=torch.float32, device=dev)
        off = torch.zeros((), dtype=torch.bool, device=dev)
        tab_t, tab_p, tab_a, tab_e = [], [], [], []
        for m in self.materials:
            rows = m.lobe_rows(None, textures) if _is_uniform(m) else []
            eta = m.eta_value(None, textures) if rows else None
            rows = rows + [(B.LAMBERTIAN_REFL, zero_p, off)] * (M - len(rows))
            tab_t.append([t for t, _, _ in rows])
            tab_p += [p.to(dev) for _, p, _ in rows]
            tab_a += [a.to(dev) for _, _, a in rows]
            tab_e.append(eta)
        if all(isinstance(t, int) for r in tab_t for t in r):
            tab_t = torch.tensor(tab_t, dtype=torch.int32, device=dev)
        else:
            tab_t = torch.stack([torch.stack([torch.as_tensor(
                t, dtype=torch.int32, device=dev) for t in r])
                for r in tab_t])
        if all(e is None for e in tab_e):
            tab_e = None
        else:
            one = torch.ones((), dtype=torch.float32, device=dev)
            tab_e = torch.stack([one if e is None else e.to(dev)
                                 for e in tab_e])
        n_mat = len(self.materials)
        return (tab_t, torch.stack(tab_p).view(n_mat, M * 16),
                torch.stack(tab_a).view(n_mat, M), tab_e)

    def _lane_rows(self, m, si, textures, atlas):
        """-> (types (B, M), params (B, M, 16), active (B, M)) of material
        ``m`` evaluated on every lane, padded with inactive rows."""
        n, dev = si.t.shape[0], si.t.device
        rows = m.lobe_rows(si, textures, atlas)
        lt = torch.zeros((n, self.max_lobes), dtype=torch.int32, device=dev)
        la = torch.zeros((n, self.max_lobes), dtype=torch.bool, device=dev)
        for j, (t, _, a) in enumerate(rows):
            lt[:, j] = t
            la[:, j] = a
        pad = [torch.zeros((n, 16), dtype=torch.float32, device=dev)] \
            * (self.max_lobes - len(rows))
        lp = torch.stack([p.expand(n, 16) for _, p, _ in rows] + pad, 1)
        return lt, lp, la

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

    def _atlas_values(self, si, textures, midc, texels):
        """One EWA lookup per slot -> {id(texture): (B, 3)} per material;
        ``texels``: ``_texel_rows``'s."""
        n_slots, slot_tab, regs, _ = self.atlas_prep()
        if not n_slots or "atlas_meta" not in textures:
            return None
        dev = si.t.device
        meta, levels = textures["atlas_meta"], textures["atlas_levels"]
        if _levels_require_grad(textures):
            # rows built from the levels: the graph reaches them
            qidx = None
            if A.all_repeat(regs):
                images = textures["images"]
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

    def lookups(self, textures, dev) -> Lookups:
        """What the scene's textures take when evaluated outside
        ``shade``: the scene's texel rows (``_texel_rows``) and no atlas
        values, so that each image texture makes its per-texture lookup."""
        return Lookups({}, None, self._texel_rows(textures, dev)
                       if "atlas_meta" in textures else None)

    def _texel_rows(self, textures, dev):
        """The texel rows the lookups read: the atlas's rows where the
        scene has atlas slots, else the (T, 3) texels of
        ``textures["images"]`` (built once per images list and level
        versions). While a level requires grad (grad mode on) they are the
        (T, 3) texels built from the levels on every call, so that the
        lookups' gradient reaches the levels (K17 reads them at stride 3
        where the atlas holds quad rows: the same texels)."""
        images = textures["images"]
        if _levels_require_grad(textures):
            return A.atlas_texels(images).to(dev)
        tables = self.atlas_tables(textures, dev)
        if tables is not None:
            return tables[1]
        return self._cached(("texels", False, dev), images,
                            lambda: A.atlas_texels(images).to(dev),
                            [lv._version for pyr in images for lv in pyr])

    def shade(self, si, ctx):
        """-> (si, LobeStack) of every lane; lanes without a material or
        hit get inactive lobes. ``si`` comes back with the bumped shading
        frame (ns, ss, ts) on the lanes of a material with a bump map,
        unchanged where no material has one."""
        textures = ctx.textures
        dev = si.t.device
        n, n_mat, M = si.t.shape[0], len(self.materials), self.max_lobes
        tab_t, tab_p, tab_a, tab_e = self._uniform_table(textures, dev)
        midc = si.material.clamp(0, n_mat - 1)
        mid = midc.long()
        lt = tab_t[mid]
        lp = row_gather(tab_p, midc.int()).view(n, M, 16)
        la = tab_a[mid]
        eta = torch.ones_like(si.t) if tab_e is None else tab_e[mid]
        textured = [i for i, m in enumerate(self.materials)
                    if not _is_uniform(m)]
        frame = None
        if textured:
            rows = self._texel_rows(textures, dev) \
                if "atlas_meta" in textures else None
            atlas = self._atlas_values(si, textures, mid, rows)
            # the texel rows K17 reads; none where no material needs a
            # per-texture lookup
            texels = rows if self.per_texture_images() else None
            for i in textured:
                m = self.materials[i]
                sel = si.material == i
                look = None if atlas is None and texels is None else \
                    Lookups(atlas[i] if atlas is not None else {}, si.uv,
                            texels)
                si_b = m.apply_bump(si, textures, look)
                t, p, a = self._lane_rows(m, si_b, textures, look)
                lt = torch.where(sel[:, None], t, lt)
                lp = torch.where(sel[:, None, None], p, lp)
                la = torch.where(sel[:, None], a, la)
                e = m.eta_value(si_b, textures, look)
                if e is not None:
                    eta = torch.where(sel, e, eta)
                if si_b is not si:
                    frame = frame or (si.ns, si.ss, si.ts)
                    frame = tuple(torch.where(sel[:, None], new, old)
                                  for new, old in zip(
                                      (si_b.ns, si_b.ss, si_b.ts), frame))
        active = la & (si.material >= 0)[:, None] & si.valid[:, None]
        if frame is not None:
            si = dataclasses.replace(si, ns=frame[0], ss=frame[1],
                                     ts=frame[2])
        return si, B.LobeStack(type=lt, params=lp, active=active, eta=eta,
                               fourier=textures.get("fourier"))
