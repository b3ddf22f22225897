"""Lobe-stack BSDF evaluation (port of rustracer_tpu/ops/bsdf.py: the
Lambertian reflection and transmission, Oren-Nayar, microfacet reflection
and transmission, FresnelBlend and the five Disney lobes, the three
specular lobes and the Fourier BSDF: every lobe type of the reference).

Every lane carries up to M lobes as (type, params[16], active) rows; f and
pdf sum or average the active matching lobes over the lobe types statically
present in the scene (``types_present``, a tuple), and sampling picks the
k-th matching lobe. A FOURIER lobe reads the scene's table set
(``LobeStack.fourier``, ops/fourier.py; its rows only, hand kernel K19);
one without a table set raises, where the reference would leave it black.

Param slots (the reference's layout):
  [0:3] primary color, [3:6] secondary color (T, conductor eta),
  [6:9] tertiary color (conductor k), [9] eta, [10] alpha_x, [11] alpha_y,
  [12] microfacet distribution code, [13] fresnel code,
  [14] Oren-Nayar A, Disney metallic or roughness,
  [15] Oren-Nayar B, the clearcoat's GTR1 alpha, the Fourier table id.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.math import (INV_PI, PI, abs_cos_theta, cos_theta, dot,
                         normalize, reflect, refract, same_hemisphere)
from ..core.sampling import cosine_sample_hemisphere
from .fresnel import (FR_CONDUCTOR, FR_DIELECTRIC, FR_DISNEY, fr_conductor,
                      fr_dielectric, schlick_fresnel)
from .microfacet import (GTR1, TROWBRIDGE, distribution_d, distribution_g,
                         distribution_pdf, distribution_sample_wh)

# --- lobe type codes (the reference's) ---
LAMBERTIAN_REFL = 0
OREN_NAYAR = 1
LAMBERTIAN_TRANS = 2
SPECULAR_REFL = 3
SPECULAR_TRANS = 4
FRESNEL_SPECULAR = 5
MICROFACET_REFL = 6
MICROFACET_TRANS = 7
FRESNEL_BLEND = 8
DISNEY_DIFFUSE = 9
DISNEY_RETRO = 10
DISNEY_SHEEN = 11
DISNEY_CLEARCOAT = 12
DISNEY_FAKE_SS = 13
FOURIER = 14
N_LOBE_TYPES = 15

# --- BxDF type flags ---
REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR

LOBE_FLAGS = np.zeros(N_LOBE_TYPES, np.int32)
LOBE_FLAGS[[LAMBERTIAN_REFL, OREN_NAYAR, DISNEY_DIFFUSE, DISNEY_RETRO,
            DISNEY_SHEEN, DISNEY_FAKE_SS]] = REFLECTION | DIFFUSE
LOBE_FLAGS[LAMBERTIAN_TRANS] = TRANSMISSION | DIFFUSE
LOBE_FLAGS[SPECULAR_REFL] = REFLECTION | SPECULAR
LOBE_FLAGS[SPECULAR_TRANS] = TRANSMISSION | SPECULAR
LOBE_FLAGS[FRESNEL_SPECULAR] = REFLECTION | TRANSMISSION | SPECULAR
LOBE_FLAGS[[MICROFACET_REFL, FRESNEL_BLEND,
            DISNEY_CLEARCOAT]] = REFLECTION | GLOSSY
LOBE_FLAGS[MICROFACET_TRANS] = TRANSMISSION | GLOSSY
LOBE_FLAGS[FOURIER] = REFLECTION | TRANSMISSION | GLOSSY

SPECULAR_TYPES = (SPECULAR_REFL, SPECULAR_TRANS, FRESNEL_SPECULAR)
# the lobes sampled from the cosine-weighted hemisphere on wo's side
DIFFUSE_LIKE = (LAMBERTIAN_REFL, OREN_NAYAR, DISNEY_DIFFUSE, DISNEY_RETRO,
                DISNEY_SHEEN, DISNEY_FAKE_SS)
DISNEY_TYPES = (DISNEY_DIFFUSE, DISNEY_RETRO, DISNEY_SHEEN, DISNEY_CLEARCOAT,
                DISNEY_FAKE_SS)
PORTED_TYPES = frozenset(range(N_LOBE_TYPES))
# FresnelBlend's diffuse constant, as the reference rounds it
_FB_DIFFUSE = float(28.0 / (23.0 * PI))


class LobeStack(NamedTuple):
    type: torch.Tensor     # (B, M) int32
    params: torch.Tensor   # (B, M, 16) float32
    active: torch.Tensor   # (B, M) bool
    eta: torch.Tensor      # (B,) float32: the lane's relative IOR
    fourier: object = None  # the scene's FourierTableSet (FOURIER lobes)


def check_types(types_present: Sequence[int]):
    """Raise for a lobe type the port does not evaluate: every type of
    the reference is ported, so only an unknown code raises."""
    for T in types_present:
        if T not in PORTED_TYPES:
            raise NotImplementedError(f"the lobe type {T} is not a lobe type "
                                      "of the reference")


def _table_set(fourier):
    if fourier is None:
        raise ValueError("a FOURIER lobe without a Fourier table set: a "
                         "parsed scene's LobeStack carries its tables")
    return fourier


def _fourier_lanes(fn, ltype, params, wo, wi, fourier):
    """``fn`` (fourier_f or fourier_pdf) on the FOURIER rows of (ltype
    (...), params (..., 16)) at wo, wi broadcast to them, flattened to
    lanes; zeros elsewhere."""
    batch = _batch(ltype, wo)
    mask = (ltype == FOURIER).expand(batch).reshape(-1)
    tid = params[..., 15].expand(batch).reshape(-1)
    out = fn(_table_set(fourier), tid, wo.expand(batch + (3,)).reshape(-1, 3),
             wi.expand(batch + (3,)).reshape(-1, 3), mask)
    return out.view(batch + out.shape[1:])


_FLAG_TABLES = {}


def lobe_flags(ltype):
    """Flags per lobe type: a lookup into the device's flag table."""
    tab = _FLAG_TABLES.get(ltype.device)
    if tab is None:
        tab = _FLAG_TABLES[ltype.device] = torch.as_tensor(
            LOBE_FLAGS, device=ltype.device)
    return tab[ltype.long()]


def _matches(ltype, flags):
    lf = lobe_flags(ltype)
    return (lf & flags) == lf


def _is_specular(ltype):
    return (lobe_flags(ltype) & SPECULAR) != 0


def _has_disney(types_present) -> bool:
    """FR_DISNEY comes only with the Disney lobes: without them the Disney
    Fresnel is not computed (a static choice)."""
    return any(T in DISNEY_TYPES for T in types_present)


def _fresnel(code, cos_i, params, disney=False):
    """(..., 3) reflectance by the fresnel code of slot 13 (FR_NOOP: 1);
    FR_DISNEY only where ``disney``."""
    s0 = params[..., 9]
    pb = params[..., 3:6]
    pc = params[..., 6:9]
    fd = fr_dielectric(cos_i, torch.ones_like(s0), s0)[..., None]
    fc = fr_conductor(cos_i, torch.ones_like(pb), pb, pc)
    out = torch.ones_like(fc)
    out = torch.where((code == FR_DIELECTRIC)[..., None], fd, out)
    out = torch.where((code == FR_CONDUCTOR)[..., None], fc, out)
    if not disney:
        return out
    # the metallic lerp of the dielectric and Schlick to cspec0
    metallic = params[..., 14]
    schlick = schlick_fresnel(torch.abs(cos_i)[..., None], pc)
    fdisney = (1.0 - metallic)[..., None] * fd + metallic[..., None] * schlick
    return torch.where((code == FR_DISNEY)[..., None], fdisney, out)


def _schlick_weight(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _pow5(x):
    """x ** 5 as XLA's integer_pow multiplies it out."""
    x2 = x * x
    return x * (x2 * x2)


def _half(wo, wi):
    """-> (the unit half vector, |wo + wi|^2)."""
    wh = wi + wo
    wh_len2 = wh[..., 0] * wh[..., 0] + wh[..., 1] * wh[..., 1] \
        + wh[..., 2] * wh[..., 2]
    inv = 1.0 / torch.sqrt(torch.clamp(wh_len2, min=1e-20))
    return wh * inv[..., None], wh_len2


def _full(like, v):
    return torch.full_like(like, v, dtype=torch.int32) \
        if isinstance(v, int) else torch.full_like(like, v)


def _f_one_type(T, params, wo, wi, disney=False):
    """Non-specular f of lobe type T (a static int) -> (..., 3)."""
    pa = params[..., 0:3]
    same = same_hemisphere(wo, wi)
    if T == LAMBERTIAN_REFL:
        return torch.where(same[..., None], pa * INV_PI, 0.0)
    if T == LAMBERTIAN_TRANS:
        return torch.where(same[..., None], 0.0, pa * INV_PI)
    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    if T in (DISNEY_DIFFUSE, DISNEY_RETRO, DISNEY_FAKE_SS):
        fo = _schlick_weight(aco)
        fi = _schlick_weight(aci)
    if T == DISNEY_DIFFUSE:
        f = pa * (INV_PI * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None]
        return torch.where(same[..., None], f, 0.0)
    if T in (DISNEY_RETRO, DISNEY_SHEEN, DISNEY_CLEARCOAT, DISNEY_FAKE_SS):
        wh_n, wh_len2 = _half(wo, wi)
        keep = (same & (wh_len2 > 1e-16))[..., None]
        if T == DISNEY_RETRO:
            cos_d = dot(wi, wh_n)
            rr = 2.0 * params[..., 14] * cos_d * cos_d
            f = pa * (INV_PI * rr
                      * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
        elif T == DISNEY_SHEEN:
            f = pa * _schlick_weight(dot(wi, wh_n))[..., None]
        elif T == DISNEY_CLEARCOAT:
            # GTR1 at the gloss alpha, Schlick at 0.04 and Trowbridge-Reitz
            # shadowing at a fixed alpha of 0.25
            weight = pa[..., 0]
            gloss = params[..., 15]
            dr = distribution_d(_full(weight, GTR1), wh_n, gloss, gloss)
            fr = schlick_fresnel(torch.abs(dot(wi, wh_n)), 0.04)
            gr = distribution_g(_full(weight, TROWBRIDGE), wo, wi,
                                _full(weight, 0.25), _full(weight, 0.25))
            v = weight * gr * fr * dr * 0.25
            f = torch.stack([v, v, v], -1)
        else:
            # Hanrahan-Krueger's subsurface approximation
            cos_d = dot(wi, wh_n)
            fss90 = cos_d * cos_d * params[..., 14]
            fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
            ss = 1.25 * (fss * (1.0 / torch.clamp(aco + aci, min=1e-4) - 0.5)
                         + 0.5)
            f = pa * (INV_PI * ss)[..., None]
        return torch.where(keep, f, 0.0)
    if T == OREN_NAYAR:
        A = params[..., 14]
        B = params[..., 15]
        sin_ti = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=0.0))
        sin_to = torch.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0))

        def safe(s):
            return torch.where(s < 1e-4, 1.0, s)
        cpi, spi = wi[..., 0] / safe(sin_ti), wi[..., 1] / safe(sin_ti)
        cpo, spo = wo[..., 0] / safe(sin_to), wo[..., 1] / safe(sin_to)
        d_cos = torch.clamp(cpi * cpo + spi * spo, min=0.0)
        d_cos = torch.where((sin_ti < 1e-4) | (sin_to < 1e-4), 0.0, d_cos)
        big = torch.maximum(aci, aco)
        small = torch.minimum(aci, aco)
        sin_alpha = torch.sqrt(torch.clamp(1.0 - big * big, min=0.0))
        tan_beta = torch.sqrt(torch.clamp(1.0 - small * small, min=0.0)) \
            / torch.clamp(small, min=1e-8)
        f = pa * INV_PI * (A + B * d_cos * sin_alpha * tan_beta)[..., None]
        return torch.where(same[..., None], f, 0.0)
    degenerate = (aci < 1e-8) | (aco < 1e-8)
    ax, ay = params[..., 10], params[..., 11]
    dist = params[..., 12].int()
    if T == MICROFACET_REFL:
        wh = wi + wo
        wh_len = torch.sqrt(torch.clamp(
            wh[..., 0] * wh[..., 0] + wh[..., 1] * wh[..., 1]
            + wh[..., 2] * wh[..., 2], min=1e-20))
        wh_n = wh / wh_len[..., None]
        F = _fresnel(params[..., 13].int(), dot(wi, wh_n), params, disney)
        d = distribution_d(dist, wh_n, ax, ay)
        g = distribution_g(dist, wo, wi, ax, ay)
        f = pa * F * (d * g / torch.clamp(4.0 * aci * aco, min=1e-8))[..., None]
        ok = same & ~degenerate & (wh_len > 1e-8)
        return torch.where(ok[..., None], f, 0.0)
    if T == MICROFACET_TRANS:
        eta = params[..., 9]
        # eta by the side of the surface wo is on
        e = torch.where(cos_theta(wo) > 0.0, eta, 1.0 / eta)
        wh = normalize(wo + wi * e[..., None])
        wh = torch.where((cos_theta(wh) < 0.0)[..., None], -wh, wh)
        wo_dot = dot(wo, wh)
        wi_dot = dot(wi, wh)
        ok = (~same) & ~degenerate & (wo_dot * wi_dot < 0.0)
        F = fr_dielectric(wo_dot, torch.ones_like(e), eta)
        d = distribution_d(dist, wh, ax, ay)
        g = distribution_g(dist, wo, wi, ax, ay)
        denom = (wo_dot + e * wi_dot) ** 2
        factor = 1.0 / torch.clamp(e, min=1e-8)   # radiance transport
        f = pa * ((1.0 - F) * d * g * e * e * torch.abs(wi_dot)
                  * torch.abs(wo_dot) * factor * factor
                  / torch.clamp(aci * aco * denom, min=1e-10))[..., None]
        return torch.where(ok[..., None], f, 0.0)
    if T == FRESNEL_BLEND:
        rs = params[..., 3:6]
        diffuse = _FB_DIFFUSE * pa * (1.0 - rs) \
            * ((1.0 - _pow5(1.0 - 0.5 * aci))
               * (1.0 - _pow5(1.0 - 0.5 * aco)))[..., None]
        wh_n, wh_len2 = _half(wo, wi)
        d = distribution_d(dist, wh_n, ax, ay)
        f_schlick = rs + _schlick_weight(dot(wi, wh_n))[..., None] * (1.0 - rs)
        spec = (d / torch.clamp(4.0 * torch.abs(dot(wi, wh_n))
                                * torch.maximum(aci, aco), min=1e-8)
                )[..., None] * f_schlick
        long = (wh_len2 > 1e-16)[..., None]
        ok = same[..., None] & ~degenerate[..., None] & long
        return torch.where(ok, diffuse + torch.where(long, spec, 0.0), 0.0)
    check_types((T,))
    raise AssertionError(f"lobe type {T} has no f")


def _pdf_one_type(T, params, wo, wi):
    same = same_hemisphere(wo, wi)
    if T in DIFFUSE_LIKE:
        return torch.where(same, abs_cos_theta(wi) * INV_PI, 0.0)
    if T == LAMBERTIAN_TRANS:
        return torch.where(same, 0.0, abs_cos_theta(wi) * INV_PI)
    ax, ay = params[..., 10], params[..., 11]
    dist = params[..., 12].int()
    if T == DISNEY_CLEARCOAT:
        ax = ay = params[..., 15]
        dist = _full(ax, GTR1)
    if T in (MICROFACET_REFL, DISNEY_CLEARCOAT, FRESNEL_BLEND):
        wh = normalize(wo + wi)
        pdf = distribution_pdf(dist, wo, wh, ax, ay) \
            / torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-8)
        if T == FRESNEL_BLEND:
            pdf = 0.5 * (abs_cos_theta(wi) * INV_PI + pdf)
        return torch.where(same, pdf, 0.0)
    if T == MICROFACET_TRANS:
        eta = params[..., 9]
        e = torch.where(cos_theta(wo) > 0.0, eta, 1.0 / eta)
        wh = normalize(wo + wi * e[..., None])
        wo_dot = dot(wo, wh)
        wi_dot = dot(wi, wh)
        ok = (~same) & (wo_dot * wi_dot < 0.0)
        denom = (wo_dot + e * wi_dot) ** 2
        dwh_dwi = torch.abs(e * e * wi_dot) / torch.clamp(denom, min=1e-10)
        pdf = distribution_pdf(dist, wo, wh, ax, ay) * dwh_dwi
        return torch.where(ok, pdf, 0.0)
    check_types((T,))
    raise AssertionError(f"lobe type {T} has no pdf")


def _batch(ltype, wo):
    return torch.broadcast_shapes(ltype.shape, wo.shape[:-1])


def eval_f(ltype, params, wo, wi, types_present: Sequence[int],
           fourier=None):
    """Masked dispatch of _f_one_type over the present types (the specular
    ones have f 0); FOURIER through the table set ``fourier``."""
    check_types(types_present)
    disney = _has_disney(types_present)
    out = wo.new_zeros(_batch(ltype, wo) + (3,))
    for T in types_present:
        if T == FOURIER:
            from .fourier import fourier_f
            val = _fourier_lanes(fourier_f, ltype, params, wo, wi, fourier)
        elif T in SPECULAR_TYPES:
            continue
        else:
            val = _f_one_type(T, params, wo, wi, disney)
        out = torch.where((ltype == T)[..., None], val, out)
    return out


def eval_pdf(ltype, params, wo, wi, types_present: Sequence[int],
             fourier=None):
    check_types(types_present)
    out = wo.new_zeros(_batch(ltype, wo))
    for T in types_present:
        if T == FOURIER:
            from .fourier import fourier_pdf
            val = _fourier_lanes(fourier_pdf, ltype, params, wo, wi, fourier)
        elif T in SPECULAR_TYPES:
            continue
        else:
            val = _pdf_one_type(T, params, wo, wi)
        out = torch.where(ltype == T, val, out)
    return out


def _any_type(ltype, types):
    mask = ltype == types[0]
    for T in types[1:]:
        mask = mask | (ltype == T)
    return mask


def _normal_by_side(entering):
    """(0, 0, 1) where ``entering``, else (0, 0, -1)."""
    z = torch.where(entering, 1.0, -1.0)
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z], -1)


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)


def sample_lobe(ltype, params, wo, u, types_present: Sequence[int],
                fourier=None):
    """wi from the chosen lobe (ltype (B,), params (B, 16)) ->
    (wi, specular f, specular pdf, is specular). A non-specular lobe's f
    and pdf are summed over all lobes afterwards."""
    check_types(types_present)
    wi = torch.zeros_like(wo)
    spec_f = torch.zeros_like(wo)
    spec_pdf = torch.zeros_like(wo[..., 0])
    cos_o = cos_theta(wo)
    pa = params[..., 0:3]
    pb = params[..., 3:6]
    eta = params[..., 9]

    diffuse_like = [T for T in types_present if T in DIFFUSE_LIKE]
    if diffuse_like or LAMBERTIAN_TRANS in types_present:
        w_cos = cosine_sample_hemisphere(u)
        flip = w_cos.new_tensor([1.0, 1.0, -1.0])
    if diffuse_like:
        w = torch.where((cos_o < 0.0)[..., None], w_cos * flip, w_cos)
        wi = torch.where(_any_type(ltype, diffuse_like)[..., None], w, wi)
    if LAMBERTIAN_TRANS in types_present:
        # the hemisphere opposite wo
        w = torch.where((cos_o > 0.0)[..., None], w_cos * flip, w_cos)
        wi = torch.where((ltype == LAMBERTIAN_TRANS)[..., None], w, wi)
    glossy = [T for T in (MICROFACET_REFL, DISNEY_CLEARCOAT)
              if T in types_present]
    if glossy or MICROFACET_TRANS in types_present:
        # one sampler call for every microfacet lobe; the clearcoat's lanes
        # take GTR1 at their gloss alpha
        ax, ay = params[..., 10], params[..., 11]
        dist = params[..., 12].int()
        if DISNEY_CLEARCOAT in types_present:
            is_cc = ltype == DISNEY_CLEARCOAT
            ax = torch.where(is_cc, params[..., 15], ax)
            ay = torch.where(is_cc, params[..., 15], ay)
            dist = torch.where(is_cc, GTR1, dist)
        wh = distribution_sample_wh(dist, wo, u, ax, ay)
    if glossy:
        wi = torch.where(_any_type(ltype, glossy)[..., None],
                         reflect(wo, wh), wi)
    if MICROFACET_TRANS in types_present:
        e = torch.where(cos_o > 0.0, 1.0 / eta, eta)
        wh_f = torch.where((dot(wo, wh) < 0.0)[..., None], -wh, wh)
        w, ok = refract(wo, wh_f, e)
        w = torch.where(ok[..., None], w, -wo)  # TIR: degenerate, f 0
        wi = torch.where((ltype == MICROFACET_TRANS)[..., None], w, wi)
    if FOURIER in types_present:
        from .fourier import fourier_sample_f
        m = ltype == FOURIER
        w, _, _ = fourier_sample_f(_table_set(fourier), params[..., 15], wo,
                                   u, m)
        wi = torch.where(m[..., None], w, wi)
    if FRESNEL_BLEND in types_present:
        # u[0] picks the half: below 0.5 the cosine lobe, else the
        # microfacet one, each on u[0] stretched back to [0, 0.9999]
        u0 = u[..., 0]
        u_d = torch.stack([torch.clamp(2.0 * u0, max=0.9999), u[..., 1]], -1)
        u_s = torch.stack([torch.clamp(2.0 * (u0 - 0.5), max=0.9999),
                           u[..., 1]], -1)
        w_d = cosine_sample_hemisphere(u_d)
        w_d = torch.where((cos_o < 0.0)[..., None],
                          w_d * w_d.new_tensor([1.0, 1.0, -1.0]), w_d)
        w_s = reflect(wo, distribution_sample_wh(
            params[..., 12].int(), wo, u_s, params[..., 10], params[..., 11]))
        w = torch.where((u0 >= 0.5)[..., None], w_s, w_d)
        wi = torch.where((ltype == FRESNEL_BLEND)[..., None], w, wi)

    # specular lobes: wi, f and pdf directly
    if SPECULAR_REFL in types_present:
        w = _mirror(wo)
        F = _fresnel(params[..., 13].int(), cos_theta(w), params,
                     _has_disney(types_present))
        f = pa * F / torch.clamp(abs_cos_theta(w), min=1e-8)[..., None]
        m = ltype == SPECULAR_REFL
        wi = torch.where(m[..., None], w, wi)
        spec_f = torch.where(m[..., None], f, spec_f)
        spec_pdf = torch.where(m, 1.0, spec_pdf)
    if SPECULAR_TRANS in types_present:
        entering = cos_o > 0.0
        e = torch.where(entering, 1.0 / eta, eta)
        w, ok = refract(wo, _normal_by_side(entering), e)
        F = fr_dielectric(cos_o, torch.ones_like(eta), eta)
        ft = pa * (1.0 - F)[..., None] * (e * e)[..., None]
        f = ft / torch.clamp(abs_cos_theta(w), min=1e-8)[..., None]
        f = torch.where(ok[..., None], f, 0.0)
        m = ltype == SPECULAR_TRANS
        wi = torch.where(m[..., None], w, wi)
        spec_f = torch.where(m[..., None], f, spec_f)
        spec_pdf = torch.where(m, 1.0, spec_pdf)
    if FRESNEL_SPECULAR in types_present:
        F = fr_dielectric(cos_o, torch.ones_like(eta), eta)
        pick_refl = u[..., 0] < F
        w_r = _mirror(wo)
        f_r = pa * F[..., None] \
            / torch.clamp(abs_cos_theta(w_r), min=1e-8)[..., None]
        entering = cos_o > 0.0
        e = torch.where(entering, 1.0 / eta, eta)
        w_t, ok = refract(wo, _normal_by_side(entering), e)
        f_t = pb * ((1.0 - F) * e * e)[..., None] \
            / torch.clamp(abs_cos_theta(w_t), min=1e-8)[..., None]
        f_t = torch.where(ok[..., None], f_t, 0.0)
        m = ltype == FRESNEL_SPECULAR
        wi = torch.where((m & pick_refl)[..., None], w_r,
                         torch.where(m[..., None], w_t, wi))
        spec_f = torch.where((m & pick_refl)[..., None], f_r,
                             torch.where(m[..., None], f_t, spec_f))
        spec_pdf = torch.where(m, torch.where(pick_refl, F, 1.0 - F),
                               spec_pdf)
    return wi, spec_f, spec_pdf, _is_specular(ltype)


def world_to_local(ss, ts, ns, v):
    return torch.stack([dot(v, ss), dot(v, ts), dot(v, ns)], dim=-1)


def local_to_world(ss, ts, ns, v):
    return v[..., 0, None] * ss + v[..., 1, None] * ts + v[..., 2, None] * ns


def num_matching(lobes: LobeStack, flags):
    m = lobes.active & _matches(lobes.type, flags)
    return m.sum(-1, dtype=torch.int32)


def bsdf_f(lobes: LobeStack, si, wo_w, wi_w, types_present, flags=ALL):
    """Sum of the matching lobes' f, with the geometric-normal
    reflect/transmit test."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = torch.abs(wo[..., 2]) > 1e-8
    reflect_w = dot(wi_w, si.n) * dot(wo_w, si.n) > 0.0
    lf = lobe_flags(lobes.type)
    hemi_ok = torch.where(reflect_w[..., None], (lf & REFLECTION) != 0,
                          (lf & TRANSMISSION) != 0)
    m = lobes.active & ((lf & flags) == lf) & hemi_ok
    f = eval_f(lobes.type, lobes.params, wo[..., None, :], wi[..., None, :],
               types_present, lobes.fourier)
    f = torch.where(m[..., None], f, 0.0).sum(-2)
    return torch.where(ok_wo[..., None], f, 0.0)


def bsdf_pdf(lobes: LobeStack, si, wo_w, wi_w, types_present, flags=ALL):
    """Average of the matching lobes' pdf."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = torch.abs(wo[..., 2]) > 1e-8
    m = lobes.active & _matches(lobes.type, flags)
    pdf = eval_pdf(lobes.type, lobes.params, wo[..., None, :],
                   wi[..., None, :], types_present, lobes.fourier)
    pdf = torch.where(m, pdf, 0.0)
    n = m.sum(-1, dtype=torch.int32)
    out = pdf.sum(-1) / torch.clamp(n.float(), min=1.0)
    return torch.where(ok_wo & (n > 0), out, 0.0)


def choose_lobe(lobes: LobeStack, m, k):
    """-> (type (B,), params (B, 16)) of the k-th lobe whose m is set
    (lobe 0 where none is): a running count over the static M."""
    ct, cp = lobes.type[:, 0], lobes.params[:, 0]
    count = m[:, 0].int()
    for j in range(1, lobes.type.shape[1]):
        hit = m[:, j] & (count == k)
        ct = torch.where(hit, lobes.type[:, j], ct)
        cp = torch.where(hit[:, None], lobes.params[:, j], cp)
        count = count + m[:, j].int()
    return ct, cp


def lobe_pick(lobes: LobeStack, u_lobe, flags):
    """-> (the matching lobes (B, M), their count n_match, the rank k =
    floor(u_lobe * n_match) of the one to sample)."""
    m = lobes.active & _matches(lobes.type, flags)
    n_match = m.sum(-1, dtype=torch.int32)
    k = torch.minimum((u_lobe * n_match.float()).int(),
                      torch.clamp(n_match - 1, min=0))
    return m, n_match, k


def bsdf_sample_f(lobes: LobeStack, si, wo_w, u_lobe, u2, types_present,
                  flags=ALL):
    """Sample a direction from the k-th matching lobe, k = floor(u_lobe *
    n_match). -> (wi_w, f (B,3), pdf (B,), sampled flags (B,), valid)."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    m, n_match, k = lobe_pick(lobes, u_lobe, flags)
    ct, cp = choose_lobe(lobes, m, k)
    specular = any(T in SPECULAR_TYPES for T in types_present)
    # the specular lobes take u[0] unclamped (FRESNEL_SPECULAR picks on it)
    u0 = torch.clamp(u2[..., 0], max=0.99999)
    if specular:
        u0 = torch.where(_is_specular(ct), u2[..., 0], u0)
    u = torch.stack([u0, u2[..., 1]], -1)
    wi, spec_f, spec_pdf, is_spec = sample_lobe(ct, cp, wo, u, types_present,
                                                lobes.fourier)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    # a non-specular lobe: f sums all lobes, pdf averages them
    f = bsdf_f(lobes, si, wo_w, wi_w, types_present, flags)
    pdf = bsdf_pdf(lobes, si, wo_w, wi_w, types_present, flags)
    if specular:
        f = torch.where(is_spec[..., None], spec_f, f)
        pdf = torch.where(is_spec, spec_pdf / torch.clamp(n_match.float(),
                                                          min=1.0), pdf)
    valid = (n_match > 0) & (torch.abs(wo[..., 2]) > 1e-8) & (pdf > 0.0)
    return (wi_w, torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0), lobe_flags(ct), valid)


def specular_reflect_branch(lobes: LobeStack, si, wo_w, types_present):
    """The deterministic mirror branch of the Whitted and direct-lighting
    integrators: wi the mirror of wo about the shading normal, weight the
    sum over the active specular-reflective lobes of R times their Fresnel
    (f |cos| / pdf of a single such lobe of pdf 1). -> (wi_w, weight
    (B, 3), present (B,))."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    cos_i = cos_theta(wi)
    weight = torch.zeros(wo.shape[:-1] + (3,), dtype=torch.float32,
                         device=wo.device)
    present = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    p = lobes.params
    for T in (SPECULAR_REFL, FRESNEL_SPECULAR):
        if T not in types_present:
            continue
        m = lobes.active & (lobes.type == T)
        cos_m = cos_i[..., None] * torch.ones_like(p[..., 9])
        if T == SPECULAR_REFL:
            F = _fresnel(p[..., 13].int(), cos_m, p,
                         _has_disney(types_present))
        else:
            F = fr_dielectric(cos_m, torch.ones_like(p[..., 9]),
                              p[..., 9])[..., None]
        weight = weight + torch.where(m[..., None], p[..., 0:3] * F,
                                      0.0).sum(-2)
        present = present | m.any(-1)
    ok = present & (torch.abs(wo[..., 2]) > 1e-8)
    return wi_w, torch.where(ok[..., None], weight, 0.0), ok


def specular_transmit_branch(lobes: LobeStack, si, wo_w, types_present):
    """The deterministic refraction branch: wi refracted through the
    shading normal by the lane's eta, weight the sum over the active
    specular-transmissive lobes of T times (1 - F) eta^2; total internal
    reflection zeroes it. -> (wi_w, weight (B, 3), present (B,))."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    cos_o = cos_theta(wo)
    entering = cos_o > 0.0
    eta = lobes.eta
    e = torch.where(entering, 1.0 / eta, eta)
    z = torch.zeros_like(wo)
    z[..., 2] = 1.0
    n = torch.where(entering[..., None], z, -z)
    wi, refr_ok = refract(wo, n, e)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    F = fr_dielectric(cos_o, torch.ones_like(eta), eta)
    scale = ((1.0 - F) * e * e)[..., None]
    weight = torch.zeros(wo.shape[:-1] + (3,), dtype=torch.float32,
                         device=wo.device)
    present = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    for T in (SPECULAR_TRANS, FRESNEL_SPECULAR):
        if T not in types_present:
            continue
        m = lobes.active & (lobes.type == T)
        kt = lobes.params[..., 0:3] if T == SPECULAR_TRANS \
            else lobes.params[..., 3:6]
        weight = weight + torch.where(m[..., None], kt, 0.0).sum(-2)
        present = present | m.any(-1)
    ok = present & refr_ok & (torch.abs(wo[..., 2]) > 1e-8)
    return wi_w, torch.where(ok[..., None], weight * scale, 0.0), ok
