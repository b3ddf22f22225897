"""Fresnel reflectance, elementwise over any batch shape (port of
rustracer_tpu/ops/fresnel.py: fr_dielectric, fr_conductor, the Schlick
approximation and the Fresnel codes a lobe's params carry)."""
from __future__ import annotations

import torch

# fresnel codes of a lobe's params slot 13
FR_NOOP, FR_DIELECTRIC, FR_CONDUCTOR, FR_DISNEY = 0, 1, 2, 3


def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; a ray leaving the medium
    (cos_theta_i < 0) swaps the etas."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = cos_theta_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_theta_i)
    sin_theta_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_theta_t = ei / et * sin_theta_i
    tir = sin_theta_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_theta_t * sin_theta_t, min=0.0))
    r_parl = ((et * ci) - (ei * ct)) / torch.clamp((et * ci) + (ei * ct),
                                                   min=1e-20)
    r_perp = ((ei * ci) - (et * ct)) / torch.clamp((ei * ci) + (et * ct),
                                                   min=1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_conductor(cos_theta_i, eta_i, eta_t, k):
    """Conductor Fresnel with a complex IOR: eta_i, eta_t and k RGB
    (..., 3); cos_theta_i (...) broadcasts against the color axis."""
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - sin2
    a2plusb2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
    t1 = a2plusb2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2plusb2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = cos2 * a2plusb2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def schlick_fresnel(cos_theta, r0):
    """Schlick's approximation."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)
