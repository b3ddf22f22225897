"""Scene geometry tables and the closest-hit / any-hit / interaction path
(port of rustracer_tpu/scene/tables.py) with hand kernels K1
(accel/traverse16.py), K14 (csrc/quadrics.cu) and K2 (csrc/interaction.cu).

Global primitive ids keep the reference's layout: [0, nq) are quadrics and
[nq, nq + T) triangles. A scene without a sphere, cylinder or disk carries
the reference's one never-hit dummy quadric (nq = 1); its quadric search
is skipped (no K14 launch), which leaves every result as it was.

Instanced triangles (the rows of instanced objects hold object-space
vertices) are hit through K1's instance records; a hit carries its
instance (-1 for static geometry), and K2 moves the triangle to world space
by the instance's transforms. Alpha cutouts are dropped inside K1's walk.
A prim with neither material nor area light is a medium interface: the
path integrator passes through it (``scene_intersect_passthrough``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..accel.bvh_build import build_wide_arrays, identity_instances
from ..accel.traverse16 import traverse16
from ..core.interaction import Interaction, make_shading_frame
from ..core.math import INFINITY, cross, face_forward, gamma, normalize
from ..core.ray import Ray
from ..core.transform import (apply_mat3, xform_normal, xform_point,
                              xform_vector)
from ..ops.quadrics import quadric_hit_t, quadric_intersect
from ..ops.triangle import (triangle_intersect, triangle_normal_derivs,
                            triangle_partial_derivs, triangle_point_error)

# the dummy quadric's count: the triangle ids of a scene without quadrics
# start here
N_DUMMY_QUADRICS = 1
QUADRIC_KEYS = ("q_type", "q_o2w", "q_w2o", "q_params", "q_material",
                "q_arealight", "q_reverse")


def dummy_quadric() -> dict:
    """The reference's never-hit placeholder: a zero-radius sphere over
    z in [1, 2] (rustracer_tpu/scene/tables.py _dummy_quadric)."""
    return dict(
        q_type=np.zeros(1, np.int32),
        q_o2w=np.eye(4, dtype=np.float32)[None],
        q_w2o=np.eye(4, dtype=np.float32)[None],
        q_params=np.array([[0.0, 1.0, 2.0, 2.0 * np.pi]], np.float32),
        q_material=np.full(1, -1, np.int32),
        q_arealight=np.full(1, -1, np.int32),
        q_reverse=np.zeros(1, bool))


def dummy_tris() -> dict:
    """One degenerate, never-hit triangle: the triangle tables of a scene
    of quadrics alone (rustracer_tpu/scene/tables.py _dummy_tris)."""
    return dict(
        tv_p=np.zeros((3, 3), np.float32), tv_n=np.zeros((3, 3), np.float32),
        tv_uv=np.zeros((3, 2), np.float32), tv_s=np.zeros((3, 3), np.float32),
        t_idx=np.zeros((1, 3), np.int32), t_material=np.full(1, -1, np.int32),
        t_arealight=np.full(1, -1, np.int32), t_reverse=np.zeros(1, bool),
        t_has_n=np.zeros(1, bool), t_has_uv=np.zeros(1, bool))


@dataclasses.dataclass
class GeometryTables:
    """Device tables of a scene.

    t_shade row layout (one (T, 32) row gather per hit):
      [0:9) p0 p1 p2 | [9:18) n0 n1 n2 | [18:24) uv0 uv1 uv2 |
      24 flags (bit0 has_uv, bit1 has_n, bit2 reverse; int32 bits) |
      25 material | 26 area light (int32 bits) | 27:32 zero
    Quadrics (the dummy's one row when the scene has none): q_params rows
    as ops/quadrics.py lays them out; q_reverse is reverse_orientation ^
    swaps_handedness.
    """
    tv_p: torch.Tensor          # (V, 3) f32
    t_idx: torch.Tensor         # (T, 3) i32
    t_reverse: torch.Tensor     # (T,) bool
    t_shade: torch.Tensor       # (T, 32) f32
    bvh16_table: torch.Tensor   # (R, 128) f32 (accel/bvh_build.py layout)
    bvh16_roots: torch.Tensor   # (8,) i32 per-octant root rows
    bvh16_depth: int            # wide-tree depth (stack size of the walk)
    q_type: torch.Tensor        # (Q,) i32: 0 sphere, 1 cylinder, 2 disk
    q_o2w: torch.Tensor         # (Q, 4, 4) f32
    q_w2o: torch.Tensor         # (Q, 4, 4) f32
    q_params: torch.Tensor      # (Q, 4) f32
    q_material: torch.Tensor    # (Q,) i32 (-1 none)
    q_arealight: torch.Tensor   # (Q,) i32 (-1 none)
    q_reverse: torch.Tensor     # (Q,) bool
    # False when the one quadric row is the dummy: a real quadric has a
    # material or an area light (make_geometry refuses one with neither),
    # the dummy neither. Read once here, on the host.
    has_quadrics: bool = dataclasses.field(init=False)
    # alpha cutouts: per-triangle alpha and shadow-alpha map ids (-1 none)
    # into the baked atlas (scene/bundle.py bake_alpha); a one-texel atlas
    # means the scene has none
    t_alpha_tex: torch.Tensor         # (T,) i32
    t_shadow_alpha_tex: torch.Tensor  # (T,) i32
    alpha_atlas: torch.Tensor         # (A,) f32 texels
    alpha_meta: torch.Tensor          # (K, 3) i32 offset, width, height
    # instances (accel/bvh_build.py build_wide_scene): one identity row
    # means the scene has none
    inst_o2w: torch.Tensor            # (I, 4, 4) f32
    inst_w2o: torch.Tensor            # (I, 4, 4) f32
    inst_flip: torch.Tensor           # (I,) bool: swaps handedness
    # a real prim has neither material nor area light (a medium interface)
    has_interfaces: bool
    # the reference's shape tests, read once here on the host: more than
    # one instance row, more than one atlas texel
    has_instances: bool = dataclasses.field(init=False)
    has_alpha: bool = dataclasses.field(init=False)

    def __post_init__(self):
        self.has_quadrics = bool((self.q_material[0] >= 0)
                                 | (self.q_arealight[0] >= 0))
        self.has_instances = self.inst_o2w.shape[0] > 1
        self.has_alpha = self.alpha_atlas.shape[0] > 1

    @property
    def n_quadrics(self):
        return self.q_type.shape[0]

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


def make_geometry(tris: dict = None, bvh: dict = None, quadrics: dict = None,
                  device="cuda", alpha: dict = None) -> GeometryTables:
    """Host arrays (numpy, the reference's ``tris`` and ``quadrics`` dicts)
    -> device tables; no quadric gives the dummy row, no triangle the
    dummy triangle. ``bvh`` is the output of
    ``accel.bvh_build.build_wide_arrays`` (built here when absent) or of
    ``build_wide_scene``, with the instance tables; ``alpha`` holds
    ``alpha_atlas`` and ``alpha_meta`` (scene/bundle.py). The caller's
    dicts are read, never modified."""
    has_q = quadrics is not None and len(quadrics.get("q_type", [])) > 0
    has_t = tris is not None and len(tris.get("t_idx", [])) > 0
    # medium interfaces among the real prims (the dummies have neither
    # material nor area light but are never hit)
    iface = any(
        has and bool(np.any((np.asarray(src[mk]) < 0)
                            & (np.asarray(src[ak]) < 0)))
        for src, has, mk, ak in ((tris, has_t, "t_material", "t_arealight"),
                                 (quadrics, has_q, "q_material",
                                  "q_arealight")))
    q = quadrics if has_q else dummy_quadric()
    tris = tris if has_t else dummy_tris()
    n_t = len(tris["t_idx"])
    if bvh is None:
        bvh = build_wide_arrays(tris["tv_p"], tris["t_idx"])
    inst = {k: bvh.get(k, v) for k, v in identity_instances().items()}
    if alpha is None:
        alpha = dict(alpha_atlas=np.ones(1, np.float32),
                     alpha_meta=np.zeros((1, 3), np.int32))

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
        bvh16_depth=int(bvh["bvh16_depth"]),
        q_type=tens(q["q_type"], torch.int32),
        q_o2w=tens(q["q_o2w"], torch.float32),
        q_w2o=tens(q["q_w2o"], torch.float32),
        q_params=tens(q["q_params"], torch.float32),
        q_material=tens(q["q_material"], torch.int32),
        q_arealight=tens(q["q_arealight"], torch.int32),
        q_reverse=tens(q["q_reverse"], torch.bool),
        t_alpha_tex=tens(tris.get("t_alpha_tex", np.full(n_t, -1)),
                         torch.int32),
        t_shadow_alpha_tex=tens(tris.get("t_shadow_alpha_tex",
                                         np.full(n_t, -1)), torch.int32),
        alpha_atlas=tens(alpha["alpha_atlas"], torch.float32),
        alpha_meta=tens(alpha["alpha_meta"], torch.int32),
        inst_o2w=tens(inst["inst_o2w"], torch.float32),
        inst_w2o=tens(inst["inst_w2o"], torch.float32),
        inst_flip=tens(inst["inst_flip"], torch.bool),
        has_interfaces=iface)


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def quadric_object_ray(geom: GeometryTables, i: int, o, d):
    """Rays (o, d) in quadric i's object space as component triples: rows
    0-2 of its w2o in the reference's component form (tables.py:253-258),
    as K14 computes them."""
    m = geom.q_w2o[i]
    oc = tuple(m[r, 0] * o[:, 0] + m[r, 1] * o[:, 1] + m[r, 2] * o[:, 2]
               + m[r, 3] for r in range(3))
    dc = tuple(m[r, 0] * d[:, 0] + m[r, 1] * d[:, 1] + m[r, 2] * d[:, 2]
               for r in range(3))
    return oc, dc


def intersect_quadrics_all_plain(geom: GeometryTables, o, d, t_max):
    """Plain PyTorch version of K14's closest hit: the reference's loop
    over the quadrics (rustracer_tpu/scene/tables.py intersect_quadrics_all)
    -> (hit, t (INF on a miss), qid (0 on a miss))."""
    t_best = t_max
    qid = torch.full(t_max.shape, -1, dtype=torch.int32, device=t_max.device)
    for i, q_type in enumerate(geom.q_type.tolist()):
        t, hit = quadric_hit_t(q_type, *quadric_object_ray(geom, i, o, d),
                               t_best, geom.q_params[i])
        better = hit & (t < t_best)
        t_best = torch.where(better, t, t_best)
        qid = torch.where(better, i, qid)
    hit = qid >= 0
    return hit, torch.where(hit, t_best, INFINITY), qid.clamp(min=0)


def _check_quadric_call(geom, o, d, t_max):
    n, dev = o.shape[0], o.device
    nq = geom.n_quadrics
    cuda.check(geom.q_type, "q_type", torch.int32, (nq,), dev)
    cuda.check(geom.q_w2o, "q_w2o", torch.float32, (nq, 4, 4), dev)
    cuda.check(geom.q_params, "q_params", torch.float32, (nq, 4), dev)
    cuda.check(o, "o", torch.float32, (n, 3), dev)
    cuda.check(d, "d", torch.float32, (n, 3), dev)
    cuda.check(t_max, "t_max", torch.float32, (n,), dev)


def intersect_quadrics_all(geom: GeometryTables, o, d, t_max):
    """Closest hit of the rays (o (B, 3), d (B, 3), t_max (B,)) over every
    quadric -> (hit, t (INF on a miss), qid (0 on a miss)). CPU tensors
    take the plain version, CUDA tensors launch K14 (quadric_closest)."""
    if not cuda.use_kernel(o):
        return intersect_quadrics_all_plain(geom, o, d, t_max)
    _check_quadric_call(geom, o, d, t_max)
    n, dev = o.shape[0], o.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    qid = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        cuda.launch("quadric_closest", geom.q_type, geom.q_w2o,
                    geom.q_params, geom.n_quadrics, o, d, t_max, n, hit, t,
                    qid)
    return hit, t, qid


def quadrics_any_hit(geom: GeometryTables, o, d, t_max):
    """(B,) bool: the ray hits some quadric below t_max (the closest
    search's hit). CPU tensors take the plain version, CUDA tensors launch
    K14 (quadric_any), which stops at the first hit."""
    if not cuda.use_kernel(o):
        return intersect_quadrics_all_plain(geom, o, d, t_max)[0]
    _check_quadric_call(geom, o, d, t_max)
    n, dev = o.shape[0], o.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        cuda.launch("quadric_any", geom.q_type, geom.q_w2o, geom.q_params,
                    geom.n_quadrics, o, d, t_max, n, hit)
    return hit


def closest_prim(geom: GeometryTables, ray: Ray, with_inst: bool = False):
    """-> (hit, t (INF on a miss), global prim id int32 (0 on a miss)) and,
    ``with_inst``, the hit's instance (-1 for a static or quadric hit and a
    miss): the quadrics' closest hit tightens the triangles' t_max (K1,
    which drops cut-out triangles), the triangle wins only when it is
    strictly nearer (the reference's _closest_prim)."""
    nq = geom.n_quadrics
    if not geom.has_quadrics:
        hit, t, tid, inst = traverse16(geom, ray.o, ray.d, ray.t_max,
                                       any_hit=False, with_inst=True)
        out = (hit, t, torch.where(hit, tid + nq, 0))
        return out + (inst,) if with_inst else out
    qhit, qt, qid = intersect_quadrics_all(geom, ray.o, ray.d, ray.t_max)
    thit, tt, tid, inst = traverse16(geom, ray.o, ray.d,
                                     torch.where(qhit, qt, ray.t_max),
                                     any_hit=False, with_inst=True)
    use_tri = thit & (~qhit | (tt < qt))
    out = (qhit | thit, torch.where(use_tri, tt, qt),
           torch.where(use_tri, tid + nq, qid))
    return out + (torch.where(use_tri, inst, -1),) if with_inst else out


RAY_GRAD = "a gradient through a sampled ray direction"


def scene_intersect(geom: GeometryTables, ray: Ray) -> Interaction:
    """Closest hit over the scene -> full surface interaction batch (alpha
    cutouts skipped inside K1, so the interaction is rebuilt against the
    caller's ray at the accepted t). A ray whose o or d requires grad
    (grad mode on) raises: the hit carries no gradient to it yet (ROADMAP
    item B12)."""
    cuda.refuse_grad(RAY_GRAD, (ray.o, ray.d))
    if not geom.has_instances:
        return build_interaction(geom, ray, *closest_prim(geom, ray))
    return build_interaction(geom, ray, *closest_prim(geom, ray,
                                                      with_inst=True))


def _si_where(mask, a: Interaction, b: Interaction) -> Interaction:
    """Per-lane select of two interaction batches (mask (B,))."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out[f.name] = torch.where(m, x, y)
    return Interaction(**out)


def scene_intersect_passthrough(geom: GeometryTables, ray: Ray,
                                max_skips: int = 8) -> Interaction:
    """Closest hit that passes through medium interfaces (a prim with
    neither material nor area light; the reference's path.rs:143-152):
    lanes whose hit is one re-trace from ``spawn_ray(ray.d)`` there, up to
    ``max_skips`` rounds, while the other lanes get t_max 0 (K1 ends them
    at once); one host test a round. A scene without interfaces takes one
    intersection. A ray that requires grad raises (``scene_intersect``)."""
    si = scene_intersect(geom, ray)
    if not geom.has_interfaces or max_skips <= 0:
        return si
    o_cur = ray.o
    for _ in range(max_skips):
        pend = si.valid & (si.material < 0) & (si.arealight < 0)
        if not bool(pend.any()):
            break
        r2 = si.spawn_ray(ray.d)
        o_cur = torch.where(pend[:, None], r2.o, o_cur)
        s2 = scene_intersect(geom, Ray(o=o_cur, d=ray.d, t_max=torch.where(
            pend, r2.t_max, 0.0)))
        si = _si_where(pend, s2, si)
    return si


def scene_intersect_p(geom: GeometryTables, ray: Ray):
    """Any-hit (shadow) test -> (B,) bool occluded: a quadric occluder
    zeroes the triangles' t_max (K1 then ends the ray at once); K1 drops
    triangles cut out by their alpha or shadow-alpha map. A ray that
    requires grad raises (``scene_intersect``)."""
    cuda.refuse_grad(RAY_GRAD, (ray.o, ray.d))
    if not geom.has_quadrics:
        return traverse16(geom, ray.o, ray.d, ray.t_max, any_hit=True)[0]
    qhit = quadrics_any_hit(geom, ray.o, ray.d, ray.t_max)
    thit = traverse16(geom, ray.o, ray.d,
                      torch.where(qhit, 0.0, ray.t_max), any_hit=True)[0]
    return qhit | thit


# ---------------------------------------------------------------------------
# interaction rebuild (K2)
# ---------------------------------------------------------------------------

_FIELDS3 = ("p", "p_error", "n", "dpdu", "dpdv", "ns", "ss", "ts", "dndu",
            "dndv", "wo")


def _quadric_branch(geom: GeometryTables, ray: Ray, hit, t, prim):
    """The quadric branch of the reference's build_interaction (:556-595)
    for every lane's quadric (prim clipped into [0, nq)) -> dict of world
    p, p_error, n, uv, dpdu, dpdv, dndu, dndv, material, arealight."""
    qid = prim.clamp(0, geom.n_quadrics - 1).long()
    w2o, o2w = geom.q_w2o[qid], geom.q_o2w[qid]              # (B, 4, 4)
    params, q_type = geom.q_params[qid], geom.q_type[qid]
    qh = quadric_intersect(q_type, xform_point(w2o, ray.o),
                           xform_vector(w2o, ray.d),
                           torch.where(hit, t * 1.0001 + 1e-4, ray.t_max),
                           params)
    # conservative world-space error: |M| err + gamma(3) (|M| |p| + |trans|)
    abs_m = torch.abs(o2w)
    e1 = torch.stack(apply_mat3(abs_m, *qh.p_error.unbind(-1)), dim=-1)
    e2 = torch.stack(apply_mat3(abs_m, *torch.abs(qh.p).unbind(-1)), dim=-1)
    dpdu = xform_vector(o2w, qh.dpdu)
    dpdv = xform_vector(o2w, qh.dpdv)
    rev = geom.q_reverse[qid][:, None]
    n = normalize(cross(dpdu, dpdv))
    # normal derivatives in closed form: n = p / r on a sphere, so dn/du =
    # dp/du / r and dn/dv = dp/dv / r; a cylinder's dn/du = dp/du / r, its
    # dn/dv = 0; a disk is flat (the Weingarten equations give the same)
    inv_r = 1.0 / torch.clamp(params[:, 0], min=1e-8)
    ku = torch.where(q_type == 2, 0.0, inv_r)[:, None]
    kv = torch.where(q_type == 0, inv_r, 0.0)[:, None]
    dndu = xform_normal(w2o, qh.dpdu * ku)
    dndv = xform_normal(w2o, qh.dpdv * kv)
    return dict(
        p=xform_point(o2w, qh.p),
        p_error=e1 + gamma(3) * (e2 + torch.abs(o2w[:, :3, 3])),
        n=torch.where(rev, -n, n), uv=qh.uv, dpdu=dpdu, dpdv=dpdv,
        dndu=torch.where(rev, -dndu, dndu), dndv=torch.where(rev, -dndv, dndv),
        material=geom.q_material[qid], arealight=geom.q_arealight[qid])


def build_interaction_plain(geom: GeometryTables, ray: Ray, hit, t, prim,
                            inst=None):
    """Plain PyTorch version of K2: the reference's build_interaction, the
    quadric branch (when the scene has quadrics) and the triangle branch
    selected per lane, then the shading frame and the miss-lane
    placeholders. ``inst`` (an instanced scene's hits): a triangle of
    instance inst >= 0 has its vertices moved to world space by
    inst_o2w[inst], its vertex normals by inst_w2o[inst], and its
    orientation flipped by inst_flip[inst] (the reference's :606-647)."""
    is_tri = prim >= geom.n_quadrics
    tid = torch.where(is_tri, prim - geom.n_quadrics, 0) \
        .clamp(0, geom.n_triangles - 1)
    rec = geom.t_shade[tid.long()]                           # (B, 32)
    p0, p1, p2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    nv0, nv1, nv2 = rec[:, 9:12], rec[:, 12:15], rec[:, 15:18]
    flags = rec[:, 24].view(torch.int32)
    rev = ((flags & 4) != 0)[:, None]
    if inst is not None:
        use = (inst >= 0)[:, None]
        i = inst.clamp(min=0).long()
        o2w, w2o = geom.inst_o2w[i], geom.inst_w2o[i]
        p0, p1, p2 = (torch.where(use, xform_point(o2w, v), v)
                      for v in (p0, p1, p2))
        nv0, nv1, nv2 = (torch.where(use, xform_normal(w2o, v), v)
                         for v in (nv0, nv1, nv2))
        rev = rev ^ (use & geom.inst_flip[i][:, None])
    th = triangle_intersect(ray.o, ray.d,
                            torch.where(hit, t * 1.0001 + 1e-4, ray.t_max),
                            p0, p1, p2)
    has_uv = ((flags & 1) != 0)[:, None]
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    uv0 = torch.where(has_uv, rec[:, 18:20], torch.stack([zero, zero], -1))
    uv1 = torch.where(has_uv, rec[:, 20:22], torch.stack([one, zero], -1))
    uv2 = torch.where(has_uv, rec[:, 22:24], torch.stack([one, one], -1))
    b0, b1, b2 = th.b0[:, None], th.b1[:, None], th.b2[:, None]
    p, p_error = triangle_point_error(th.b0, th.b1, th.b2, p0, p1, p2)
    uv = b0 * uv0 + b1 * uv1 + b2 * uv2
    dpdu, dpdv = triangle_partial_derivs(p0, p1, p2, uv0, uv1, uv2)
    ng = normalize(cross(p0 - p2, p1 - p2))
    ng = torch.where(rev, -ng, ng)
    has_n = ((flags & 2) != 0)[:, None]
    n_interp = normalize(b0 * nv0 + b1 * nv1 + b2 * nv2)
    n_interp = torch.where(rev, -n_interp, n_interp)
    ns = torch.where(has_n, n_interp, ng)
    ng = torch.where(has_n, face_forward(ng, ns), ng)
    dndu, dndv = triangle_normal_derivs(nv0, nv1, nv2, uv0, uv1, uv2)
    z3 = torch.zeros_like(dndu)
    dndu = torch.where(has_n & ~rev, dndu, torch.where(has_n & rev, -dndu, z3))
    dndv = torch.where(has_n & ~rev, dndv, torch.where(has_n & rev, -dndv, z3))
    material = rec[:, 25].view(torch.int32)
    arealight = rec[:, 26].view(torch.int32)
    if geom.has_quadrics:
        q = _quadric_branch(geom, ray, hit, t, prim)
        tri3 = is_tri[:, None]

        def w(a, b):
            return torch.where(tri3 if a.dim() == 2 else is_tri, a, b)
        p, p_error, uv = w(p, q["p"]), w(p_error, q["p_error"]), w(uv, q["uv"])
        ng, ns = w(ng, q["n"]), w(ns, q["n"])
        dpdu, dpdv = w(dpdu, q["dpdu"]), w(dpdv, q["dpdv"])
        dndu, dndv = w(dndu, q["dndu"]), w(dndv, q["dndv"])
        material = w(material, q["material"])
        arealight = w(arealight, q["arealight"])
    ss, ts = make_shading_frame(ns, dpdu)

    h = hit[:, None]
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
        material=torch.where(hit, material, neg1),
        arealight=torch.where(hit, arealight, neg1),
        prim_id=torch.where(hit, prim, neg1),
        dndu=torch.where(h & torch.isfinite(dndu), dndu, z3),
        dndv=torch.where(h & torch.isfinite(dndv), dndv, z3))


def build_interaction(geom: GeometryTables, ray: Ray, hit, t, prim,
                      inst=None):
    """Surface interactions of closest hits (hit (B,) bool, t (B,) f32,
    prim (B,) int32 global ids; ``inst`` (B,) int32 the hits' instances in
    an instanced scene, else None). CPU tensors take the plain version,
    CUDA tensors launch K2 (triangle and quadric lanes in one launch; the
    instantiation with the instance branch, ``build_interaction_inst``,
    where ``inst`` is given)."""
    if not cuda.use_kernel(t):
        return build_interaction_plain(geom, ray, hit, t, prim, inst)
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
    nq = geom.n_quadrics
    for name, dtype, shape in (("q_type", torch.int32, (nq,)),
                               ("q_o2w", torch.float32, (nq, 4, 4)),
                               ("q_w2o", torch.float32, (nq, 4, 4)),
                               ("q_params", torch.float32, (nq, 4)),
                               ("q_material", torch.int32, (nq,)),
                               ("q_arealight", torch.int32, (nq,)),
                               ("q_reverse", torch.bool, (nq,))):
        cuda.check(getattr(geom, name), name, dtype, shape, dev)
    f3 = {k: torch.empty((n, 3), dtype=torch.float32, device=dev)
          for k in _FIELDS3}
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ids = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    extra = ()
    if inst is not None:
        ni = geom.inst_o2w.shape[0]
        cuda.check(inst, "inst", torch.int32, (n,), dev)
        cuda.check(geom.inst_o2w, "inst_o2w", torch.float32, (ni, 4, 4), dev)
        cuda.check(geom.inst_w2o, "inst_w2o", torch.float32, (ni, 4, 4), dev)
        cuda.check(geom.inst_flip, "inst_flip", torch.bool, (ni,), dev)
        extra = (inst, geom.inst_o2w, geom.inst_w2o, geom.inst_flip)
    if n:
        cuda.launch("build_interaction_inst" if extra else
                    "build_interaction", geom.t_shade, geom.n_triangles, nq,
                    int(geom.has_quadrics), *(getattr(geom, k) for k in QUADRIC_KEYS), ray.o, ray.d,
                    ray.t_max, hit, t, prim, n,
                    f3["p"], f3["p_error"], f3["n"], uv, f3["dpdu"],
                    f3["dpdv"], f3["ns"], f3["ss"], f3["ts"], f3["dndu"],
                    f3["dndv"], f3["wo"], *ids, *extra)
    return Interaction(valid=hit, t=t, uv=uv, material=ids[0],
                       arealight=ids[1], prim_id=ids[2], **f3)
