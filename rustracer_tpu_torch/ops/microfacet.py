"""Microfacet distributions, elementwise in shading space (z the normal):
Beckmann, Trowbridge-Reitz and the GTR1 clearcoat distribution (port of
rustracer_tpu/ops/microfacet.py: D, Lambda, G1, G, the sampling pdf, the
samplers and the roughness remap).

``dist`` is a per-lane code tensor; every function evaluates each
distribution and selects, as the reference does, so a lane's result does
not depend on its neighbours'.
"""
from __future__ import annotations

import torch

from ..core.math import (PI, abs_cos_theta, cos2_phi, cos2_theta,
                         cos_theta, normalize, sin2_phi, tan2_theta,
                         tan_theta)

BECKMANN, TROWBRIDGE, GTR1 = 0, 1, 2
_PI = float(PI)


def roughness_to_alpha(roughness):
    """PBRT's remap of a roughness to alpha."""
    roughness = torch.clamp(torch.as_tensor(roughness), min=1e-3)
    x = torch.log(roughness)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * (x * (x * x)) + 0.000640711 * ((x * x) * (x * x)))


def distribution_d(dist, wh, alpha_x, alpha_y):
    """The differential area D(wh)."""
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    c4 = c2 * c2
    finite = torch.isfinite(t2)
    ax2 = alpha_x * alpha_x
    ay2 = alpha_y * alpha_y
    e = cos2_phi(wh) / ax2 + sin2_phi(wh) / ay2
    beck = torch.exp(-t2 * e) / (_PI * alpha_x * alpha_y * c4)
    e = e * t2
    tr = 1.0 / (_PI * alpha_x * alpha_y * c4 * (1.0 + e) ** 2)
    # GTR1: alpha_x is its alpha
    denom = _PI * torch.log(torch.clamp(ax2, min=1e-8)) \
        * (1.0 + (ax2 - 1.0) * c2)
    gtr1 = (ax2 - 1.0) / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    d = torch.where(dist == BECKMANN, beck,
                    torch.where(dist == TROWBRIDGE, tr, gtr1))
    return torch.where(finite, d, 0.0)


def distribution_lambda(dist, w, alpha_x, alpha_y):
    """The shadowing auxiliary Lambda(w)."""
    abs_tan = torch.abs(tan_theta(w))
    finite = torch.isfinite(abs_tan)
    abs_tan_safe = torch.where(finite, abs_tan, 0.0)
    alpha = torch.sqrt(torch.clamp(
        cos2_phi(w) * alpha_x * alpha_x + sin2_phi(w) * alpha_y * alpha_y,
        min=1e-20))
    # Beckmann's rational approximation
    a = 1.0 / torch.clamp(alpha * abs_tan_safe, min=1e-20)
    beck = torch.where(a >= 1.6, 0.0,
                       (1.0 - 1.259 * a + 0.396 * a * a)
                       / torch.clamp(3.535 * a + 2.181 * a * a, min=1e-20))
    # Trowbridge-Reitz's closed form (GTR1's too)
    a2t2 = (alpha * abs_tan_safe) ** 2
    tr = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    lam = torch.where(dist == BECKMANN, beck, tr)
    return torch.where(finite, lam, 0.0)


def distribution_g1(dist, w, alpha_x, alpha_y):
    return 1.0 / (1.0 + distribution_lambda(dist, w, alpha_x, alpha_y))


def distribution_g(dist, wo, wi, alpha_x, alpha_y):
    return 1.0 / (1.0 + distribution_lambda(dist, wo, alpha_x, alpha_y)
                  + distribution_lambda(dist, wi, alpha_x, alpha_y))


def distribution_pdf(dist, wo, wh, alpha_x, alpha_y):
    """The pdf of distribution_sample_wh: visible normals for
    Trowbridge-Reitz, D |cos wh| for Beckmann and GTR1."""
    d = distribution_d(dist, wh, alpha_x, alpha_y)
    vis = d * distribution_g1(dist, wo, alpha_x, alpha_y) \
        * torch.abs(wo[..., 0] * wh[..., 0] + wo[..., 1] * wh[..., 1]
                    + wo[..., 2] * wh[..., 2]) \
        / torch.clamp(abs_cos_theta(wo), min=1e-8)
    plain = d * abs_cos_theta(wh)
    return torch.where(dist == TROWBRIDGE, vis, plain)


def _aniso_phi(u1, alpha_x, alpha_y):
    phi = torch.atan(alpha_y / alpha_x
                     * torch.tan(2.0 * _PI * u1 + 0.5 * _PI))
    return torch.where(u1 > 0.5, phi + _PI, phi)


def _from_tan2(tan2, phi):
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def _sample_beckmann_full(u, alpha_x, alpha_y):
    """A Beckmann wh from the full distribution."""
    log_u = torch.log(torch.clamp(1.0 - u[..., 0], min=1e-20))
    iso = torch.isclose(alpha_x, alpha_y)
    tan2_iso = -alpha_x * alpha_x * log_u
    phi_iso = u[..., 1] * 2.0 * _PI
    phi_a = _aniso_phi(u[..., 1], alpha_x, alpha_y)
    sp, cp = torch.sin(phi_a), torch.cos(phi_a)
    tan2_a = -log_u / (cp * cp / (alpha_x * alpha_x)
                       + sp * sp / (alpha_y * alpha_y))
    return _from_tan2(torch.where(iso, tan2_iso, tan2_a),
                      torch.where(iso, phi_iso, phi_a))


def _sample_tr_full(u, alpha_x, alpha_y):
    """A Trowbridge-Reitz wh from the full distribution."""
    iso = torch.isclose(alpha_x, alpha_y)
    phi_iso = 2.0 * _PI * u[..., 1]
    tan2_iso = alpha_x * alpha_x * u[..., 0] \
        / torch.clamp(1.0 - u[..., 0], min=1e-20)
    phi_a = _aniso_phi(u[..., 1], alpha_x, alpha_y)
    sp, cp = torch.sin(phi_a), torch.cos(phi_a)
    a2 = 1.0 / (cp * cp / (alpha_x * alpha_x) + sp * sp / (alpha_y * alpha_y))
    tan2_a = a2 * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-20)
    return _from_tan2(torch.where(iso, tan2_iso, tan2_a),
                      torch.where(iso, phi_iso, phi_a))


def _sample_gtr1(u, alpha):
    a2 = alpha * alpha
    ct = torch.sqrt(torch.clamp(
        (1.0 - torch.pow(torch.clamp(a2, min=1e-8), 1.0 - u[..., 0]))
        / torch.clamp(1.0 - a2, min=1e-8), min=0.0))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = 2.0 * _PI * u[..., 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def _sample_visible_area(wo, u, alpha_x, alpha_y):
    """Heitz's visible-normal sampling through Trowbridge-Reitz slopes."""
    flip = cos_theta(wo) < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)
    # stretch wo
    wi_s = normalize(torch.stack([alpha_x * wo_f[..., 0],
                                  alpha_y * wo_f[..., 1], wo_f[..., 2]], -1))
    ct = cos_theta(wi_s)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    tan_t = st / torch.clamp(ct, min=1e-8)
    tiny = st < 1e-7
    cp = torch.where(tiny, 1.0, wi_s[..., 0] / torch.clamp(st, min=1e-7))
    sp = torch.where(tiny, 0.0, wi_s[..., 1] / torch.clamp(st, min=1e-7))
    u1, u2 = u[..., 0], u[..., 1]

    # normal incidence
    normal_inc = ct > 0.9999
    r = torch.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-20),
                               min=0.0))
    phi = 2.0 * _PI * u2
    sx_n = r * torch.cos(phi)
    sy_n = r * torch.sin(phi)
    # x slope (Heitz and d'Eon)
    a = 1.0 / torch.clamp(tan_t, min=1e-20)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))
    A = torch.clamp(2.0 * u1 / torch.clamp(g1, min=1e-20) - 1.0,
                    -0.9999, 0.9999)
    tmp = 1.0 / (A * A - 1.0)
    tmp = torch.where(torch.abs(tmp) > 1e10, torch.sign(tmp) * 1e10, tmp)
    b = tan_t
    d = torch.sqrt(torch.clamp(b * b * tmp * tmp - (A * A - b * b) * tmp,
                               min=0.0))
    sx1 = b * tmp - d
    sx2 = b * tmp + d
    sx = torch.where((A < 0.0) | (sx2 > 1.0 / torch.clamp(tan_t, min=1e-20)),
                     sx1, sx2)
    # y slope
    S = torch.where(u2 > 0.5, 1.0, -1.0)
    u2b = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2b * (u2b * (u2b * 0.27385 - 0.73369) + 0.46341)) / \
        (u2b * (u2b * (u2b * 0.093073 + 0.309420) - 1.0) + 0.597999)
    sy = S * z * torch.sqrt(1.0 + sx * sx)
    slope_x = torch.where(normal_inc, sx_n, sx)
    slope_y = torch.where(normal_inc, sy_n, sy)
    # rotate, unstretch
    rx = (cp * slope_x - sp * slope_y) * alpha_x
    ry = (sp * slope_x + cp * slope_y) * alpha_y
    wh = normalize(torch.stack([-rx, -ry, torch.ones_like(rx)], -1))
    return torch.where(flip[..., None], -wh, wh)


def distribution_sample_wh(dist, wo, u, alpha_x, alpha_y):
    """A half vector wh: Trowbridge-Reitz by visible normals, Beckmann
    from the full distribution, GTR1 by the clearcoat sampler; each pairs
    with distribution_pdf."""
    wh_vis = _sample_visible_area(wo, u, alpha_x, alpha_y)
    wh_beck = _sample_beckmann_full(u, alpha_x, alpha_y)
    wh_gtr = _sample_gtr1(u, alpha_x)
    wh = torch.where((dist == TROWBRIDGE)[..., None], wh_vis,
                     torch.where((dist == BECKMANN)[..., None], wh_beck,
                                 wh_gtr))
    # full-distribution samples land in wo's hemisphere
    flip_full = (dist != TROWBRIDGE) & (cos_theta(wo) < 0.0)
    return torch.where(flip_full[..., None], -wh, wh)
