"""Surface interactions as struct-of-arrays batches (port of
rustracer_tpu/core/interaction.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .math import (INFINITY, coordinate_system, cross, dot, normalize,
                   offset_ray_origin)
from .ray import Ray


@dataclasses.dataclass
class Interaction:
    valid: torch.Tensor       # (B,) bool: the ray hit something
    t: torch.Tensor           # (B,)
    p: torch.Tensor           # (B, 3)
    p_error: torch.Tensor     # (B, 3)
    wo: torch.Tensor          # (B, 3)
    n: torch.Tensor           # (B, 3) geometric normal
    uv: torch.Tensor          # (B, 2)
    dpdu: torch.Tensor        # (B, 3)
    dpdv: torch.Tensor        # (B, 3)
    ns: torch.Tensor          # (B, 3) shading normal
    ss: torch.Tensor          # (B, 3) shading tangent
    ts: torch.Tensor          # (B, 3) shading bitangent
    material: torch.Tensor    # (B,) int32 (-1 none)
    arealight: torch.Tensor   # (B,) int32 (-1 none)
    prim_id: torch.Tensor     # (B,) int32 global primitive id (-1 miss)
    dndu: torch.Tensor        # (B, 3) shading-normal derivatives
    dndv: torch.Tensor
    # texture differentials: zeros until compute_differentials fills them
    dudx: Optional[torch.Tensor] = None
    dvdx: Optional[torch.Tensor] = None
    dudy: Optional[torch.Tensor] = None
    dvdy: Optional[torch.Tensor] = None
    dpdx: Optional[torch.Tensor] = None
    dpdy: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.dudx is None:
            z = torch.zeros_like(self.t)
            self.dudx = self.dvdx = self.dudy = self.dvdy = z
            self.dpdx = self.dpdy = torch.zeros_like(self.p)

    def spawn_ray(self, d) -> Ray:
        """New ray leaving the surface, origin offset past the error box."""
        o = offset_ray_origin(self.p, self.p_error, self.n, d)
        return Ray(o=o, d=d, t_max=torch.full_like(self.t, INFINITY))


def make_shading_frame(n, dpdu):
    """Orthonormal shading frame with z = n and x close to dpdu."""
    ss = normalize(dpdu - dot(dpdu, n)[..., None] * n)
    degenerate = dot(ss, ss) < 1e-12
    fb_u, _ = coordinate_system(n)
    ss = torch.where(degenerate[..., None], fb_u, ss)
    return ss, cross(n, ss)


def compute_differentials(si: Interaction, ray: Ray) -> Interaction:
    """Forward-difference texture differentials: intersect the offset rays
    with the tangent plane at p and solve the 2x2 system for du/dv."""
    if not ray.has_differentials:
        return si
    n, p = si.n, si.p
    one = torch.ones_like(si.t)

    def plane_t(o, d):
        nd = dot(n, d)
        return (dot(n, p) - dot(n, o)) / torch.where(nd == 0.0, one, nd)

    px = ray.rx_origin + plane_t(ray.rx_origin, ray.rx_direction)[..., None] \
        * ray.rx_direction
    py = ray.ry_origin + plane_t(ray.ry_origin, ray.ry_direction)[..., None] \
        * ray.ry_direction
    dpdx = px - p
    dpdy = py - p
    # the two dimensions where the normal is smallest: drop argmax |n|
    k = torch.argmax(torch.abs(n), dim=-1)
    d0 = torch.where(k == 0, 1, 0)[..., None]
    d1 = torch.where(k == 2, 1, 2)[..., None]

    def take(v, i):
        return torch.gather(v, -1, i)[..., 0]

    a00, a01 = take(si.dpdu, d0), take(si.dpdv, d0)
    a10, a11 = take(si.dpdu, d1), take(si.dpdv, d1)
    det = a00 * a11 - a01 * a10
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, one)
    zero = torch.zeros_like(det)

    def solve(b0, b1):
        x0 = (a11 * b0 - a01 * b1) * inv
        x1 = (a00 * b1 - a10 * b0) * inv
        return torch.where(ok, x0, zero), torch.where(ok, x1, zero)

    dudx, dvdx = solve(take(dpdx, d0), take(dpdx, d1))
    dudy, dvdy = solve(take(dpdy, d0), take(dpdy, d1))
    bad = ~(torch.isfinite(dudx) & torch.isfinite(dvdx)
            & torch.isfinite(dudy) & torch.isfinite(dvdy))
    return dataclasses.replace(
        si,
        dudx=torch.where(bad, zero, dudx), dvdx=torch.where(bad, zero, dvdx),
        dudy=torch.where(bad, zero, dudy), dvdy=torch.where(bad, zero, dvdy),
        dpdx=torch.where(bad[..., None], torch.zeros_like(dpdx), dpdx),
        dpdy=torch.where(bad[..., None], torch.zeros_like(dpdy), dpdy))
