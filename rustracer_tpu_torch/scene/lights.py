"""Light tables and light sampling (port of rustracer_tpu/scene/lights.py,
the subset for area lights on triangles with the per-light precompute; the
spatial grid that picks among them is scene/lightdistrib.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import absdot, distance_squared, dot
from ..ops.triangle import triangle_sample

# the reference's light type codes
LIGHT_POINT, LIGHT_DISTANT, LIGHT_AREA, LIGHT_INFINITE = 0, 1, 2, 3
_NOT_PORTED = {LIGHT_POINT: "point", LIGHT_DISTANT: "distant",
               LIGHT_INFINITE: "infinite"}


@dataclasses.dataclass
class LightTables:
    l_type: torch.Tensor      # (L,) int32, all LIGHT_AREA
    l_emit: torch.Tensor      # (L, 3) emitted radiance
    l_prim: torch.Tensor      # (L,) int32 global prim id
    l_twosided: torch.Tensor  # (L,) bool
    l_area: torch.Tensor      # (L,) f32 triangle area
    l_tri_p: torch.Tensor     # (L, 3, 3) triangle vertices, world space
    l_tri_rev: torch.Tensor   # (L,) bool reverse orientation
    world_center: torch.Tensor = None   # (3,) the scene bounds' centre
    world_radius: float = 100.0         # radius of the bounds' sphere

    @property
    def n_lights(self):
        return self.l_type.shape[0]


def make_lights(rows, geom, world_center=(0.0, 0.0, 0.0), world_radius=100.0,
                device="cuda") -> LightTables:
    """rows: dicts (type, emit, prim, twosided), every row an area light on
    a triangle of ``geom``. Triangle vertices and areas are precomputed so
    per-lane sampling reads only these (L, ...) tables. ``world_center``
    and ``world_radius`` bound the scene (the reference's distant lights
    read them). Point, distant and infinite lights and area lights on
    quadrics raise NotImplementedError."""
    nq = geom.n_quadrics
    tv_p = geom.tv_p.cpu().numpy()
    t_idx = geom.t_idx.cpu().numpy()
    t_rev = geom.t_reverse.cpu().numpy()
    L = len(rows)
    l_area = np.zeros(L, np.float32)
    l_tri_p = np.zeros((L, 3, 3), np.float32)
    l_tri_rev = np.zeros(L, bool)
    for i, r in enumerate(rows):
        if r["type"] in _NOT_PORTED:
            raise NotImplementedError(
                f"{_NOT_PORTED[r['type']]} lights are not ported yet "
                "(ROADMAP.md, section A, item 14)")
        if r["type"] != LIGHT_AREA or r.get("prim", -1) < nq:
            raise NotImplementedError(
                "area lights on quadrics are not ported yet (ROADMAP.md, "
                "section A, item 14); only area lights on triangles are")
        tid = int(r["prim"]) - nq
        pts = tv_p[t_idx[tid]]
        l_tri_p[i] = pts
        l_tri_rev[i] = bool(t_rev[tid])
        c = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        l_area[i] = np.float32(0.5) * np.float32(np.sqrt(np.float32(np.dot(c, c))))

    def tens(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return LightTables(
        l_type=tens([r["type"] for r in rows], torch.int32),
        l_emit=tens([r["emit"] for r in rows], torch.float32),
        l_prim=tens([r["prim"] for r in rows], torch.int32),
        l_twosided=tens([r.get("twosided", False) for r in rows], torch.bool),
        l_area=tens(l_area, torch.float32), l_tri_p=tens(l_tri_p, torch.float32),
        l_tri_rev=tens(l_tri_rev, torch.bool),
        world_center=tens(np.asarray(world_center, np.float32),
                          torch.float32),
        world_radius=float(world_radius))


@dataclasses.dataclass
class LightSample:
    wi: torch.Tensor          # (B, 3)
    li: torch.Tensor          # (B, 3)
    pdf: torch.Tensor         # (B,) solid-angle pdf
    p_target: torch.Tensor    # (B, 3) point on the light
    n_target: torch.Tensor    # (B, 3)
    err_target: torch.Tensor  # (B, 3)


def sample_li(lt: LightTables, lid, si, u) -> LightSample:
    """Uniform-area sample of triangle light ``lid`` (B,) seen from si.p."""
    lid = lid.long()
    pts = lt.l_tri_p[lid]
    p_a, n_a, err_a = triangle_sample(u, pts[:, 0], pts[:, 1], pts[:, 2])
    n_a = torch.where(lt.l_tri_rev[lid][:, None], -n_a, n_a)
    d_a = p_a - si.p
    dist2 = torch.clamp(dot(d_a, d_a), min=1e-12)
    wi = d_a * torch.rsqrt(torch.clamp(dist2, min=1e-20))[:, None]
    cos_l = dot(n_a, -wi)
    facing = torch.where(lt.l_twosided[lid], torch.abs(cos_l) > 1e-7,
                         cos_l > 1e-7)
    li = torch.where(facing[:, None], lt.l_emit[lid], 0.0)
    pdf = dist2 / torch.clamp(torch.abs(cos_l) * lt.l_area[lid], min=1e-12)
    pdf = torch.where(facing, pdf, 0.0)
    return LightSample(wi=wi, li=li, pdf=pdf, p_target=p_a, n_target=n_a,
                       err_target=err_a)


def pdf_li_hit(lt: LightTables, lid, prev_p, d, p_hit, n_hit):
    """Solid-angle pdf with which sample_li at prev_p picks the direction d
    toward the known hit (p_hit, n_hit) on light row lid (-1: none)."""
    area = lt.l_area[lid.clamp(0, lt.n_lights - 1).long()]
    dist2 = torch.clamp(distance_squared(prev_p, p_hit), min=1e-12)
    cos_l = absdot(n_hit, d)
    pdf = dist2 / torch.clamp(cos_l * area, min=1e-12)
    return torch.where((lid >= 0) & (cos_l > 1e-7), pdf, 0.0)


def arealight_le(lt: LightTables, arealight_id, n, w):
    """Radiance an area light's surface emits toward w."""
    lid = arealight_id.clamp(0, lt.n_lights - 1).long()
    ok = (arealight_id >= 0) & (lt.l_twosided[lid] | (dot(n, w) > 0.0))
    return torch.where(ok[:, None], lt.l_emit[lid], 0.0)
