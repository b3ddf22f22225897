"""Scene geometry tables and the closest-hit / any-hit / interaction path
(port of rustracer_tpu/scene/tables.py for triangle scenes) with hand
kernel K2 (csrc/interaction.cu).

Global primitive ids keep the reference's layout: [0, nq) are quadrics and
[nq, nq + T) triangles. The port accepts no real quadric yet; every scene
carries the reference's one never-hit dummy quadric (nq = 1), so the
quadric branch of the reference is skipped while the ids stay the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..accel.bvh_build import build_wide_arrays
from ..accel.traverse16 import traverse16
from ..core.interaction import Interaction, make_shading_frame
from ..core.math import cross, face_forward, normalize
from ..core.ray import Ray
from ..ops.triangle import (triangle_intersect, triangle_normal_derivs,
                            triangle_partial_derivs, triangle_point_error)

N_DUMMY_QUADRICS = 1


@dataclasses.dataclass
class GeometryTables:
    """Device tables of a triangle scene.

    t_shade row layout (one (T, 32) row gather per hit):
      [0:9) p0 p1 p2 | [9:18) n0 n1 n2 | [18:24) uv0 uv1 uv2 |
      24 flags (bit0 has_uv, bit1 has_n, bit2 reverse; int32 bits) |
      25 material | 26 area light (int32 bits) | 27:32 zero
    """
    tv_p: torch.Tensor          # (V, 3) f32
    t_idx: torch.Tensor         # (T, 3) i32
    t_reverse: torch.Tensor     # (T,) bool
    t_shade: torch.Tensor       # (T, 32) f32
    bvh16_table: torch.Tensor   # (R, 128) f32 (accel/bvh_build.py layout)
    bvh16_roots: torch.Tensor   # (8,) i32 per-octant root rows
    bvh16_depth: int            # wide-tree depth (stack size of the walk)
    n_quadrics: int = N_DUMMY_QUADRICS

    @property
    def n_triangles(self):
        return self.t_idx.shape[0]


def pack_shade_rows(t: dict) -> np.ndarray:
    """Per-triangle shading attributes -> (T, 32) float32 rows."""
    idx = np.asarray(t["t_idx"], np.int32)
    tv_p = np.asarray(t["tv_p"], np.float32)
    tv_n = np.asarray(t["tv_n"], np.float32)
    tv_uv = np.asarray(t["tv_uv"], np.float32)
    rec = np.zeros((idx.shape[0], 32), np.float32)
    for v in range(3):
        rec[:, 3 * v:3 * v + 3] = tv_p[idx[:, v]]
        rec[:, 9 + 3 * v:12 + 3 * v] = tv_n[idx[:, v]]
        rec[:, 18 + 2 * v:20 + 2 * v] = tv_uv[idx[:, v]]
    flags = (np.asarray(t["t_has_uv"]).astype(np.int32)
             | (np.asarray(t["t_has_n"]).astype(np.int32) << 1)
             | (np.asarray(t["t_reverse"]).astype(np.int32) << 2))
    rec[:, 24] = flags.view(np.float32)
    rec[:, 25] = np.asarray(t["t_material"], np.int32).view(np.float32)
    rec[:, 26] = np.asarray(t["t_arealight"], np.int32).view(np.float32)
    return rec


def make_geometry(tris: dict, bvh: dict = None, quadrics: dict = None,
                  device="cuda") -> GeometryTables:
    """Host arrays (numpy, the reference's ``tris`` dict) -> device tables.

    ``bvh`` is the output of ``accel.bvh_build.build_wide_arrays``, built
    here when absent. The caller's dicts are read, never modified."""
    if quadrics is not None and len(quadrics.get("q_type", [])):
        raise NotImplementedError(
            "quadric shapes are not ported yet (ROADMAP.md, section A, "
            "item 5); only triangle scenes render")
    for key in ("t_alpha_tex", "t_shadow_alpha_tex"):
        if key in tris and np.any(np.asarray(tris[key]) >= 0):
            raise NotImplementedError(f"{key}: alpha cutouts are not ported "
                                      "yet (ROADMAP.md, section A, item 15)")
    if np.any((np.asarray(tris["t_material"]) < 0)
              & (np.asarray(tris["t_arealight"]) < 0)):
        raise NotImplementedError("medium-interface triangles (no material, "
                                  "no area light) are not ported yet")
    if bvh is None:
        bvh = build_wide_arrays(tris["tv_p"], tris["t_idx"])

    def tens(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return GeometryTables(
        tv_p=tens(tris["tv_p"], torch.float32),
        t_idx=tens(tris["t_idx"], torch.int32),
        t_reverse=tens(tris["t_reverse"], torch.bool),
        t_shade=tens(pack_shade_rows(tris), torch.float32),
        bvh16_table=tens(bvh["bvh16_table"], torch.float32),
        bvh16_roots=tens(bvh["bvh16_roots"], torch.int32),
        bvh16_depth=int(bvh["bvh16_depth"]))


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def closest_prim(geom: GeometryTables, ray: Ray):
    """-> (hit, t (INF on a miss), global prim id int32 (0 on a miss))."""
    hit, t, tid = traverse16(geom, ray.o, ray.d, ray.t_max, any_hit=False)
    return hit, t, torch.where(hit, tid + geom.n_quadrics, 0)


def scene_intersect(geom: GeometryTables, ray: Ray) -> Interaction:
    """Closest hit over the scene -> full surface interaction batch."""
    hit, t, prim = closest_prim(geom, ray)
    return build_interaction(geom, ray, hit, t, prim)


def scene_intersect_p(geom: GeometryTables, ray: Ray):
    """Any-hit (shadow) test -> (B,) bool occluded."""
    return traverse16(geom, ray.o, ray.d, ray.t_max, any_hit=True)[0]


# ---------------------------------------------------------------------------
# interaction rebuild (K2)
# ---------------------------------------------------------------------------

_FIELDS3 = ("p", "p_error", "n", "dpdu", "dpdv", "ns", "ss", "ts", "dndu",
            "dndv", "wo")


def build_interaction_plain(geom: GeometryTables, ray: Ray, hit, t, prim):
    """Plain PyTorch version of K2: the triangle branch of the reference's
    build_interaction, then the miss-lane placeholders."""
    is_tri = prim >= geom.n_quadrics
    tid = torch.where(is_tri, prim - geom.n_quadrics, 0) \
        .clamp(0, geom.n_triangles - 1)
    rec = geom.t_shade[tid.long()]                           # (B, 32)
    p0, p1, p2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    th = triangle_intersect(ray.o, ray.d,
                            torch.where(hit, t * 1.0001 + 1e-4, ray.t_max),
                            p0, p1, p2)
    flags = rec[:, 24].view(torch.int32)
    has_uv = ((flags & 1) != 0)[:, None]
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    uv0 = torch.where(has_uv, rec[:, 18:20], torch.stack([zero, zero], -1))
    uv1 = torch.where(has_uv, rec[:, 20:22], torch.stack([one, zero], -1))
    uv2 = torch.where(has_uv, rec[:, 22:24], torch.stack([one, one], -1))
    b0, b1, b2 = th.b0[:, None], th.b1[:, None], th.b2[:, None]
    p, p_error = triangle_point_error(th.b0, th.b1, th.b2, p0, p1, p2)
    uv = b0 * uv0 + b1 * uv1 + b2 * uv2
    dpdu, dpdv = triangle_partial_derivs(p0, p1, p2, uv0, uv1, uv2)
    rev = ((flags & 4) != 0)[:, None]
    ng = normalize(cross(p0 - p2, p1 - p2))
    ng = torch.where(rev, -ng, ng)
    has_n = ((flags & 2) != 0)[:, None]
    nv0, nv1, nv2 = rec[:, 9:12], rec[:, 12:15], rec[:, 15:18]
    n_interp = normalize(b0 * nv0 + b1 * nv1 + b2 * nv2)
    n_interp = torch.where(rev, -n_interp, n_interp)
    ns = torch.where(has_n, n_interp, ng)
    ng = torch.where(has_n, face_forward(ng, ns), ng)
    dndu, dndv = triangle_normal_derivs(nv0, nv1, nv2, uv0, uv1, uv2)
    z3 = torch.zeros_like(dndu)
    dndu = torch.where(has_n & ~rev, dndu, torch.where(has_n & rev, -dndu, z3))
    dndv = torch.where(has_n & ~rev, dndv, torch.where(has_n & rev, -dndv, z3))
    ss, ts = make_shading_frame(ns, dpdu)

    h = (hit & is_tri)[:, None]
    axis = torch.eye(3, dtype=torch.float32, device=t.device)
    xhat, yhat, zhat = (axis[k].expand_as(p) for k in range(3))
    neg1 = torch.full_like(prim, -1)
    return Interaction(
        valid=hit, t=t, p=torch.where(h, p, ray.o),
        p_error=torch.where(h, p_error, z3), wo=normalize(-ray.d),
        n=torch.where(h, ng, zhat), uv=torch.where(h, uv, 0.0),
        dpdu=torch.where(h, dpdu, xhat), dpdv=torch.where(h, dpdv, yhat),
        ns=torch.where(h, ns, zhat), ss=torch.where(h, ss, xhat),
        ts=torch.where(h, ts, yhat),
        material=torch.where(h[:, 0], rec[:, 25].view(torch.int32), neg1),
        arealight=torch.where(h[:, 0], rec[:, 26].view(torch.int32), neg1),
        prim_id=torch.where(h[:, 0], prim, neg1),
        dndu=torch.where(h & torch.isfinite(dndu), dndu, z3),
        dndv=torch.where(h & torch.isfinite(dndv), dndv, z3))


def build_interaction(geom: GeometryTables, ray: Ray, hit, t, prim):
    """Surface interactions of closest hits (hit (B,) bool, t (B,) f32,
    prim (B,) int32 global ids). CPU tensors take the plain version, CUDA
    tensors launch K2."""
    if not cuda.use_kernel(t):
        return build_interaction_plain(geom, ray, hit, t, prim)
    n = t.shape[0]
    dev = t.device
    cuda.check(geom.t_shade, "t_shade", torch.float32,
               (geom.n_triangles, 32), dev)
    cuda.check(ray.o, "ray.o", torch.float32, (n, 3), dev)
    cuda.check(ray.d, "ray.d", torch.float32, (n, 3), dev)
    cuda.check(ray.t_max, "ray.t_max", torch.float32, (n,), dev)
    cuda.check(hit, "hit", torch.bool, (n,), dev)
    cuda.check(t, "t", torch.float32, (n,), dev)
    cuda.check(prim, "prim", torch.int32, (n,), dev)
    f3 = {k: torch.empty((n, 3), dtype=torch.float32, device=dev)
          for k in _FIELDS3}
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ids = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    if n:
        cuda.launch("build_interaction_tri", geom.t_shade, geom.n_triangles,
                    geom.n_quadrics, ray.o, ray.d, ray.t_max, hit, t, prim, n,
                    f3["p"], f3["p_error"], f3["n"], uv, f3["dpdu"],
                    f3["dpdv"], f3["ns"], f3["ss"], f3["ts"], f3["dndu"],
                    f3["dndv"], f3["wo"], *ids)
    return Interaction(valid=hit, t=t, uv=uv, material=ids[0],
                       arealight=ids[1], prim_id=ids[2], **f3)
