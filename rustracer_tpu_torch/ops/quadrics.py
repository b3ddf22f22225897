"""Sphere, cylinder and disk intersection (port of
rustracer_tpu/ops/quadrics.py): the plain PyTorch twins of hand kernel K14
(csrc/quadrics.cu, the hit test of every quadric) and of K2's quadric
branch (csrc/interaction.cu, the full hit of a lane's quadric).

Every function takes object-space rays and is branch-free (masked lanes,
no early return); the expressions keep the reference's order, which the
kernels repeat operation for operation.

Quadric parameter rows (``q_params``, (..., 4)):
  sphere:   [radius, z_min, z_max, phi_max]
  cylinder: [radius, z_min, z_max, phi_max]
  disk:     [height, radius, inner_radius, phi_max]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import PI, dot, gamma, length_squared, quadratic

# q_type codes
SPHERE, CYLINDER, DISK = 0, 1, 2
# float32 constants of the reference's expressions, rounded as it rounds
# them (csrc/quadrics.cuh holds the same bits)
TWO_PI = float(np.float32(2.0) * PI)
FULL_PHI = float(np.float32(2.0) * PI - np.float32(1e-6))


class QuadricHit(NamedTuple):
    hit: torch.Tensor      # (...) bool
    t: torch.Tensor        # (...) ray parameter
    p: torch.Tensor        # (..., 3) object-space hit point (refined)
    p_error: torch.Tensor  # (..., 3) object-space error bound
    uv: torch.Tensor       # (..., 2)
    dpdu: torch.Tensor     # (..., 3) object space
    dpdv: torch.Tensor     # (..., 3)


def _phi(x, y):
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


def _full_sphere(radius, z_min, z_max, phi_max):
    return (phi_max >= FULL_PHI) & (z_min <= -radius) & (z_max >= radius)


def _stack(*cs):
    return torch.stack(torch.broadcast_tensors(*cs), dim=-1)


def sphere_intersect(o, d, t_max, radius, z_min, z_max, phi_max):
    """Sphere (reference sphere.rs:70-200): the z- and phi-clipped partial
    sphere, with the retry at t1 when t0's hit is clipped away."""
    a = length_squared(d)
    b = 2.0 * dot(o, d)
    c = length_squared(o) - radius * radius
    t0, t1, has = quadratic(a, b, c)

    def eval_at(t):
        p = o + t[..., None] * d
        # reproject onto the sphere (the reference's refinement)
        p = p * (radius / torch.clamp(torch.sqrt(length_squared(p)),
                                      min=1e-20))[..., None]
        # phi is degenerate at the poles
        px = torch.where((p[..., 0] == 0.0) & (p[..., 1] == 0.0),
                         1e-5 * radius, p[..., 0])
        p = _stack(px, p[..., 1], p[..., 2])
        phi = _phi(p[..., 0], p[..., 1])
        z_ok = (p[..., 2] >= z_min) & (p[..., 2] <= z_max)
        clip_ok = torch.where(_full_sphere(radius, z_min, z_max, phi_max),
                              torch.ones_like(z_ok), z_ok & (phi <= phi_max))
        return p, phi, clip_ok

    p0, phi0, ok0 = eval_at(t0)
    p1, phi1, ok1 = eval_at(t1)
    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok0
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok1
    use1 = (~valid0) & valid1
    hit = valid0 | valid1
    t = torch.where(use1, t1, t0)
    p = torch.where(use1[..., None], p1, p0)
    phi = torch.where(use1, phi1, phi0)

    # parametric representation (sphere.rs:160-205)
    theta = torch.acos(torch.clamp(p[..., 2] / radius, -1.0, 1.0))
    theta_min = torch.acos(torch.clamp(z_min / radius, -1.0, 1.0))
    theta_max = torch.acos(torch.clamp(z_max / radius, -1.0, 1.0))
    u = phi / phi_max
    span = theta_max - theta_min
    span = torch.where(torch.abs(span) > 1e-9, span, 1.0)
    v = (theta - theta_min) / span
    z_radius = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    inv_zr = 1.0 / torch.clamp(z_radius, min=1e-20)
    cos_phi = p[..., 0] * inv_zr
    sin_phi = p[..., 1] * inv_zr
    dpdu = _stack(-phi_max * p[..., 1], phi_max * p[..., 0],
                  torch.zeros_like(phi))
    dpdv = _stack(p[..., 2] * cos_phi, p[..., 2] * sin_phi,
                  -radius * torch.sin(theta)) \
        * (theta_max - theta_min).expand_as(phi)[..., None]
    p_error = gamma(5) * torch.abs(p)
    return QuadricHit(hit=hit, t=t, p=p, p_error=p_error, uv=_stack(u, v),
                      dpdu=dpdu, dpdv=dpdv)


def cylinder_intersect(o, d, t_max, radius, z_min, z_max, phi_max):
    """Cylinder (reference cylinder.rs:60-200)."""
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - radius * radius
    t0, t1, has = quadratic(torch.where(a == 0.0, 1e-20, a), b, c)
    has = has & (a > 0.0)

    def eval_at(t):
        p = o + t[..., None] * d
        hit_rad = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        s = radius / torch.clamp(hit_rad, min=1e-20)
        p = _stack(p[..., 0] * s, p[..., 1] * s, p[..., 2])
        phi = _phi(p[..., 0], p[..., 1])
        ok = (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & (phi <= phi_max)
        return p, phi, ok

    p0, phi0, ok0 = eval_at(t0)
    p1, phi1, ok1 = eval_at(t1)
    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok0
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok1
    use1 = (~valid0) & valid1
    hit = valid0 | valid1
    t = torch.where(use1, t1, t0)
    p = torch.where(use1[..., None], p1, p0)
    phi = torch.where(use1, phi1, phi0)

    u = phi / phi_max
    v = (p[..., 2] - z_min) / torch.clamp(z_max - z_min, min=1e-20)
    zero = torch.zeros_like(phi)
    dpdu = _stack(-phi_max * p[..., 1], phi_max * p[..., 0], zero)
    dpdv = _stack(zero, zero, (z_max - z_min).expand_as(phi))
    p_error = gamma(3) * torch.abs(_stack(p[..., 0], p[..., 1], zero))
    return QuadricHit(hit=hit, t=t, p=p, p_error=p_error, uv=_stack(u, v),
                      dpdu=dpdu, dpdv=dpdv)


def disk_intersect(o, d, t_max, height, radius, inner_radius, phi_max):
    """Disk in the plane z = height (reference disk.rs:40-150)."""
    dz = d[..., 2]
    parallel = torch.abs(dz) < 1e-12
    t = (height - o[..., 2]) / torch.where(parallel, 1.0, dz)
    p = o + t[..., None] * d
    dist2 = p[..., 0] ** 2 + p[..., 1] ** 2
    phi = _phi(p[..., 0], p[..., 1])
    hit = (~parallel) & (t > 0.0) & (t < t_max) \
        & (dist2 <= radius * radius) \
        & (dist2 >= inner_radius * inner_radius) & (phi <= phi_max)
    r_hit = torch.sqrt(dist2)
    u = phi / phi_max
    one_minus_v = (r_hit - inner_radius) \
        / torch.clamp(radius - inner_radius, min=1e-20)
    v = 1.0 - one_minus_v
    zero = torch.zeros_like(phi)
    dpdu = _stack(-phi_max * p[..., 1], phi_max * p[..., 0], zero)
    inv_r = 1.0 / torch.clamp(r_hit, min=1e-20)
    dpdv = _stack(p[..., 0] * inv_r, p[..., 1] * inv_r, zero) \
        * ((inner_radius - radius) * torch.ones_like(phi))[..., None]
    p = _stack(p[..., 0], p[..., 1], height)
    return QuadricHit(hit=hit, t=t, p=p, p_error=torch.zeros_like(p),
                      uv=_stack(u, v), dpdu=dpdu, dpdv=dpdv)


# --- (t, hit) only, component form: the loop body of K14 ---

def _sphere_hit_t(oc, dc, t_max, radius, z_min, z_max, phi_max):
    ox, oy, oz = oc
    dx, dy, dz = dc
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = ox * ox + oy * oy + oz * oz - radius * radius
    t0, t1, has = quadratic(a, b, c)
    full = _full_sphere(radius, z_min, z_max, phi_max)

    def ok_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        s = radius / torch.clamp(torch.sqrt(px * px + py * py + pz * pz),
                                 min=1e-20)
        px, py, pz = px * s, py * s, pz * s
        px = torch.where((px == 0.0) & (py == 0.0), 1e-5 * radius, px)
        z_ok = (pz >= z_min) & (pz <= z_max)
        return full | (z_ok & (_phi(px, py) <= phi_max))

    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok_at(t0)
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok_at(t1)
    return torch.where(valid0, t0, t1), valid0 | valid1


def _cylinder_hit_t(oc, dc, t_max, radius, z_min, z_max, phi_max):
    ox, oy, oz = oc
    dx, dy, dz = dc
    a = dx * dx + dy * dy
    b = 2.0 * (dx * ox + dy * oy)
    c = ox * ox + oy * oy - radius * radius
    t0, t1, has = quadratic(torch.where(a == 0.0, 1e-20, a), b, c)
    has = has & (a > 0.0)

    def ok_at(t):
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        return (pz >= z_min) & (pz <= z_max) & (_phi(px, py) <= phi_max)

    valid0 = has & (t0 > 0.0) & (t0 < t_max) & ok_at(t0)
    valid1 = has & (t1 > 0.0) & (t1 < t_max) & ok_at(t1)
    return torch.where(valid0, t0, t1), valid0 | valid1


def _disk_hit_t(oc, dc, t_max, height, radius, inner_radius, phi_max):
    ox, oy, oz = oc
    dx, dy, dz = dc
    parallel = torch.abs(dz) < 1e-12
    t = (height - oz) / torch.where(parallel, 1.0, dz)
    px, py = ox + t * dx, oy + t * dy
    dist2 = px * px + py * py
    hit = (~parallel) & (t > 0.0) & (t < t_max) \
        & (dist2 <= radius * radius) \
        & (dist2 >= inner_radius * inner_radius) \
        & (_phi(px, py) <= phi_max)
    return t, hit


_HIT_T = (_sphere_hit_t, _cylinder_hit_t, _disk_hit_t)


def quadric_hit_t(q_type: int, oc, dc, t_max, params):
    """(t, hit) of ONE quadric of type code ``q_type`` (a Python int,
    clipped to [0, 2] as the reference's switch does) over a lane batch;
    oc/dc are object-space ray component triples."""
    return _HIT_T[min(max(int(q_type), 0), 2)](
        oc, dc, t_max, *(params[..., i] for i in range(4)))


def quadric_intersect(q_type, o, d, t_max, params):
    """Full hit of each lane's quadric: all three intersections, masked,
    then the lane's type selected (q_type (...,) int32)."""
    r = [params[..., i] for i in range(4)]
    hits = [f(o, d, t_max, *r) for f in (sphere_intersect,
                                         cylinder_intersect, disk_intersect)]

    def sel(k):
        s, c, dk = (h[k] for h in hits)
        qt = q_type if s.dim() == q_type.dim() else q_type[..., None]
        return torch.where(qt == SPHERE, s, torch.where(qt == CYLINDER, c, dk))

    return QuadricHit(*(sel(k) for k in range(len(QuadricHit._fields))))


def quadric_area(q_type, params):
    """Surface area of the clipped quadric (..., 4) parameter rows: the
    sphere's zone phi_max r (z1 - z0), the cylinder's, the annulus'
    phi_max (r^2 - r_i^2) / 2."""
    radius, z0, z1, phi_max = (params[..., i] for i in range(4))
    sphere_a = phi_max * radius * (z1 - z0)
    cyl_a = (z1 - z0) * radius * phi_max
    disk_a = params[..., 3] * 0.5 * (params[..., 1] * params[..., 1]
                                     - params[..., 2] * params[..., 2])
    return torch.where(q_type == SPHERE, sphere_a,
                       torch.where(q_type == CYLINDER, cyl_a, disk_a))


def quadric_world_bounds_np(q_type, o2w, params):
    """Host-side conservative world AABBs (numpy) -> (lo (Q, 3), hi)."""
    n = q_type.shape[0]
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    for i in range(n):
        if q_type[i] == DISK:
            h, r = params[i, 0], params[i, 1]
            obj_lo = np.array([-r, -r, h - 1e-4])
            obj_hi = np.array([r, r, h + 1e-4])
        else:
            r, z0, z1 = params[i, 0], params[i, 1], params[i, 2]
            obj_lo = np.array([-r, -r, z0])
            obj_hi = np.array([r, r, z1])
        corners = np.array([[obj_lo[0] if a == 0 else obj_hi[0],
                             obj_lo[1] if b == 0 else obj_hi[1],
                             obj_lo[2] if c == 0 else obj_hi[2]]
                            for a in (0, 1) for b in (0, 1) for c in (0, 1)],
                           np.float32)
        w = corners @ o2w[i, :3, :3].T + o2w[i, :3, 3]
        lo[i] = w.min(axis=0)
        hi[i] = w.max(axis=0)
    return lo, hi
