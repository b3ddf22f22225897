"""Light tables and light sampling (port of rustracer_tpu/scene/lights.py;
the spatial grid that picks among the lights is scene/lightdistrib.py).

Every light of a scene is one row of ``LightTables``: point, distant, area
(on a triangle or on a sphere, cylinder or disk) and infinite lights, the
infinite rows last, in the order the reference appends them (the grid's
pmf columns and the uniform pick index these rows). What a lane reads per
light is precomputed into small (L, ...) tables: a triangle light's
vertices and area, an area light's quadric (its transforms, parameter row
and clipped area), whether it is a full sphere (sampled by the cone it
subtends from outside), and each infinite light's map, frames and
``Distribution2D``. ``LightTables.kinds`` is the static set of what the
scene holds; ``sample_li`` and ``pdf_li_hit`` compute only those branches,
so a scene of triangle lights runs exactly the operations it ran before
the other types were ported.

Hand kernels: K15 ``infinite_sample`` (the infinite light's sample of
``sample_li``) and K16 ``infinite_escape`` (``infinite_le`` and
``infinite_le_mis``), csrc/lights.cu, with their plain versions here.

``pdf_li`` and ``infinite_le_one`` of the reference are used only by its
``estimate_direct`` (the direct and Whitted integrators) and wait for them
(ROADMAP.md, section A, item 16).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import cuda
from ..core.math import (PI, TWO_PI, absdot, coordinate_system,
                         distance_squared, dot, normalize, spherical_phi,
                         spherical_theta)
from ..core.sampling import (Distribution2D, concentric_sample_disk,
                             power_heuristic)
from ..core.transform import xform_normal, xform_point, xform_vector
from ..ops.mipmap import WRAP_REPEAT, bilerp_level
from ..ops.quadrics import CYLINDER, DISK, SPHERE, quadric_area
from ..ops.triangle import triangle_sample

# the reference's light type codes (-1: the dummy row of a scene without
# lights)
LIGHT_POINT, LIGHT_DISTANT, LIGHT_AREA, LIGHT_INFINITE = 0, 1, 2, 3
# float32 constants of the reference's expressions, rounded as it rounds
# them: 2 pi^2 (an infinite light's pdf over its map pdf and sin theta)
INF_PDF_SCALE = float(np.float32(2.0) * PI * PI)
# the phi_max a full sphere reaches (the cone's test)
_CONE_PHI = np.float32(2.0) * PI - np.float32(1e-4)
Y_WEIGHTS = (0.212671, 0.715160, 0.072169)
# the infinite lights' descriptor row in ``inf_desc``: H, W, then the
# offsets into ``inf_flat`` of the map (H, W, 3), the conditional func
# (H, W), cdf (H, W + 1) and integrals (H,), the marginal func (H,), cdf
# (H + 1,) and integral (1,)
INF_DESC = ("h", "w", "map", "cfunc", "ccdf", "cint", "mfunc", "mcdf",
            "mint")


@dataclasses.dataclass
class LightTables:
    l_type: torch.Tensor      # (L,) int32 (-1: dummy)
    l_pos: torch.Tensor       # (L, 3) point: position; distant: w_light
    l_emit: torch.Tensor      # (L, 3) I / L / emitted radiance / map scale
    l_prim: torch.Tensor      # (L,) int32 global prim id (area lights)
    l_twosided: torch.Tensor  # (L,) bool
    l_area: torch.Tensor      # (L,) f32 prim area (0 for non-area rows)
    l_tri_p: torch.Tensor     # (L, 3, 3) triangle vertices, world space
    l_tri_rev: torch.Tensor   # (L,) bool reverse orientation
    # an area light on a quadric: its quadric's rows (type -1 elsewhere)
    l_q_type: torch.Tensor    # (L,) int32
    l_q_o2w: torch.Tensor     # (L, 4, 4)
    l_q_w2o: torch.Tensor     # (L, 4, 4)
    l_q_params: torch.Tensor  # (L, 4)
    l_q_rev: torch.Tensor     # (L,) bool
    l_cone: torch.Tensor      # (L,) bool a full sphere: the cone from outside
    world_center: torch.Tensor  # (3,) the scene bounds' centre
    world_radius: float         # radius of the bounds' sphere
    # infinite lights, parallel to inf_rows (their rows in this table)
    inf_maps: List[torch.Tensor] = dataclasses.field(default_factory=list)
    inf_l2w: Optional[torch.Tensor] = None   # (K, 4, 4)
    inf_w2l: Optional[torch.Tensor] = None   # (K, 4, 4)
    inf_dists: List[Distribution2D] = dataclasses.field(default_factory=list)
    inf_rows: Tuple[int, ...] = ()
    inf_scale: Optional[torch.Tensor] = None  # (K, 3) their rows' l_emit
    # the kernels' copy of the maps and distributions (INF_DESC) and each
    # row's infinite light (-1 for the other rows)
    inf_flat: Optional[torch.Tensor] = None  # (F,) float32
    inf_desc: Optional[torch.Tensor] = None  # (K, 9) int32
    row_inf: Optional[torch.Tensor] = None   # (L,) int32
    # rows of the area and infinite lights (the reference's
    # l_nondelta_rows; empty when every light is a delta light)
    l_nondelta_rows: Tuple[int, ...] = ()
    # what the scene holds: "point", "distant", "tri", "quadric" (and the
    # quadric types "sphere", "cylinder", "disk"), "cone", "infinite",
    # "dummy"
    kinds: frozenset = frozenset({"tri"})

    @property
    def n_lights(self):
        return self.l_type.shape[0]

    @property
    def n_infinite(self):
        return len(self.inf_rows)

    @property
    def has_infinite(self):
        return self.n_infinite > 0


def _kinds(l_type, l_q_type, l_cone) -> frozenset:
    kinds = set()
    names = {LIGHT_POINT: "point", LIGHT_DISTANT: "distant",
             LIGHT_INFINITE: "infinite", -1: "dummy"}
    for t, qt in zip(l_type.tolist(), l_q_type.tolist()):
        if t == LIGHT_AREA:
            if qt < 0:
                kinds.add("tri")
            else:
                kinds.update(("quadric", ("sphere", "cylinder", "disk")[qt]))
        else:
            kinds.add(names[t])
    if bool(np.any(l_cone)):
        kinds.add("cone")
    return frozenset(kinds)


def infinite_importance(m) -> np.ndarray:
    """The importance image of a map (H, W, 3): luminance times the sine of
    each row's polar angle, float32."""
    h = m.shape[0]
    lum = m @ np.array(Y_WEIGHTS, np.float32)
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
    return lum * sin_theta[:, None]


def pack_infinite(maps, dists):
    """The kernels' copy of the infinite lights: (inf_flat (F,) float32,
    inf_desc (K, 9) int32), INF_DESC's layout, from host arrays."""
    parts, desc, off = [], [], 0
    for m, d in zip(maps, dists):
        h, w = m.shape[0], m.shape[1]
        row = [h, w]
        for a in (m, d.conditional.func, d.conditional.cdf,
                  d.conditional.func_int, d.marginal.func, d.marginal.cdf,
                  d.marginal.func_int):
            a = np.asarray(a, np.float32).reshape(-1)
            row.append(off)
            parts.append(a)
            off += a.size
        desc.append(row)
    flat = np.concatenate(parts) if parts else np.zeros(1, np.float32)
    return flat, np.asarray(desc, np.int32).reshape(-1, len(INF_DESC))


def make_lights(rows, geom, world_center=(0.0, 0.0, 0.0), world_radius=100.0,
                infinite=(), device="cuda") -> LightTables:
    """rows: dicts (type, pos, emit, prim, twosided) of point, distant and
    area lights; ``infinite``: dicts (map (H, W, 3), l2w (4, 4) or None,
    scale), appended after the rows, in order. An area light's triangle
    (vertices, area) or quadric (its table rows from ``geom``, clipped
    area, whether it is a full sphere) is precomputed, so per-lane sampling
    reads only these (L, ...) tables. ``world_center`` and ``world_radius``
    bound the scene (distant and infinite lights read them). A scene
    without lights gets one dummy row of type -1, which emits nothing."""
    rows = list(rows)
    inf_rows, inf_maps, inf_dists, l2ws, w2ls = [], [], [], [], []
    for spec in infinite:
        rows.append(dict(type=LIGHT_INFINITE, pos=(0, 0, 0),
                         emit=spec.get("scale", (1, 1, 1)), prim=-1,
                         twosided=False))
        inf_rows.append(len(rows) - 1)
        m = np.asarray(spec["map"], np.float32)
        l2w = spec.get("l2w")
        l2w = np.eye(4, dtype=np.float32) if l2w is None \
            else np.asarray(l2w, np.float32)
        l2ws.append(l2w)
        w2ls.append(np.linalg.inv(l2w.astype(np.float64)).astype(np.float32))
        inf_maps.append(m)
        inf_dists.append(Distribution2D.create(infinite_importance(m)))
    if not rows:
        rows = [dict(type=-1, pos=(0, 0, 0), emit=(0, 0, 0), prim=-1)]
    l_type = np.array([r["type"] for r in rows], np.int32)
    l_prim = np.array([r.get("prim", -1) for r in rows], np.int32)
    l_emit = np.array([r["emit"] for r in rows], np.float32)
    pre = area_precompute(l_type, l_prim, geom_arrays(geom))
    return LightTables(
        **light_tensors(l_type, np.array([r.get("pos", (0, 0, 0))
                                           for r in rows], np.float32),
                         l_emit, l_prim, np.array([r.get("twosided", False)
                                                   for r in rows], bool),
                         pre, world_center, world_radius, device),
        **infinite_tensors(inf_maps, inf_dists, l2ws, w2ls, inf_rows,
                            l_emit, device))


def geom_arrays(geom) -> dict:
    """The host arrays ``area_precompute`` reads from GeometryTables (the
    port's or the JAX package's)."""
    keys = ("tv_p", "t_idx", "t_reverse", "q_type", "q_o2w", "q_w2o",
            "q_params", "q_reverse")
    out = {k: np.asarray(getattr(geom, k).cpu().numpy()
                         if isinstance(getattr(geom, k), torch.Tensor)
                         else getattr(geom, k)) for k in keys}
    out["n_quadrics"] = int(out["q_type"].shape[0])
    return out


def area_precompute(l_type, l_prim, g: dict) -> dict:
    """Per-row numpy tables of the area lights from the geometry's host
    arrays ``g`` (``geom_arrays``): a triangle's vertices, orientation and
    area (float32, the reference's formula), or its quadric's rows, clipped
    area and whether it is a full sphere (the cone's test)."""
    L, nq = l_type.shape[0], g["n_quadrics"]
    out = dict(l_area=np.zeros(L, np.float32),
               l_tri_p=np.zeros((L, 3, 3), np.float32),
               l_tri_rev=np.zeros(L, bool),
               l_q_type=np.full(L, -1, np.int32),
               l_q_o2w=np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)),
               l_q_w2o=np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)),
               l_q_params=np.zeros((L, 4), np.float32),
               l_q_rev=np.zeros(L, bool), l_cone=np.zeros(L, bool))
    for i in range(L):
        prim = int(l_prim[i])
        if l_type[i] != LIGHT_AREA:
            continue
        if prim < 0:
            raise ValueError(f"light row {i}: an area light without a prim")
        if prim >= nq:
            tid = prim - nq
            pts = np.asarray(g["tv_p"][g["t_idx"][tid]], np.float32)
            out["l_tri_p"][i] = pts
            out["l_tri_rev"][i] = bool(g["t_reverse"][tid])
            c = np.cross(pts[1] - pts[0], pts[2] - pts[0])
            out["l_area"][i] = np.float32(0.5) * np.float32(
                np.sqrt(np.float32(np.dot(c, c))))
            continue
        qt = int(g["q_type"][prim])
        qp = np.asarray(g["q_params"][prim], np.float32)
        out["l_q_type"][i] = qt
        out["l_q_o2w"][i] = g["q_o2w"][prim]
        out["l_q_w2o"][i] = g["q_w2o"][prim]
        out["l_q_params"][i] = qp
        out["l_q_rev"][i] = bool(g["q_reverse"][prim])
        out["l_area"][i] = float(quadric_area(torch.tensor(qt),
                                              torch.tensor(qp)))
        r = qp[0]
        tol = np.float32(1e-5) * max(r, np.float32(1e-8))
        out["l_cone"][i] = (qt == SPHERE and qp[1] <= -r + tol
                            and qp[2] >= r - tol and qp[3] >= _CONE_PHI
                            and r > 0.0)
    return out


def light_tensors(l_type, l_pos, l_emit, l_prim, l_two, pre, world_center,
                  world_radius, device) -> dict:
    """The fields of LightTables but the infinite lights' from host arrays
    (``pre``: ``area_precompute``'s) on ``device``."""
    def tens(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    f32 = torch.float32
    return dict(
        l_type=tens(l_type, torch.int32), l_pos=tens(l_pos, f32),
        l_emit=tens(l_emit, f32), l_prim=tens(l_prim, torch.int32),
        l_twosided=tens(l_two, torch.bool),
        l_area=tens(pre["l_area"], f32), l_tri_p=tens(pre["l_tri_p"], f32),
        l_tri_rev=tens(pre["l_tri_rev"], torch.bool),
        l_q_type=tens(pre["l_q_type"], torch.int32),
        l_q_o2w=tens(pre["l_q_o2w"], f32), l_q_w2o=tens(pre["l_q_w2o"], f32),
        l_q_params=tens(pre["l_q_params"], f32),
        l_q_rev=tens(pre["l_q_rev"], torch.bool),
        l_cone=tens(pre["l_cone"], torch.bool),
        world_center=tens(np.asarray(world_center, np.float32), f32),
        world_radius=float(np.float32(world_radius)),
        l_nondelta_rows=tuple(i for i, t in enumerate(l_type.tolist())
                              if t in (LIGHT_AREA, LIGHT_INFINITE)),
        kinds=_kinds(l_type, pre["l_q_type"], pre["l_cone"]))


def infinite_tensors(maps, dists, l2ws, w2ls, inf_rows, l_emit,
                     device) -> dict:
    """The infinite lights' fields of LightTables from host arrays (maps
    (H, W, 3), Distribution2D on the CPU, frames, the rows' emission) on
    ``device``."""
    k = len(maps)
    flat, desc = pack_infinite(maps, dists)
    row_inf = np.full(l_emit.shape[0], -1, np.int32)
    row_inf[list(inf_rows)] = np.arange(k, dtype=np.int32)

    def xf(ms):
        return torch.as_tensor(np.stack(ms) if k else
                               np.zeros((0, 4, 4), np.float32),
                               dtype=torch.float32, device=device)

    return dict(
        inf_maps=[torch.as_tensor(m, dtype=torch.float32, device=device)
                  for m in maps],
        inf_l2w=xf(l2ws), inf_w2l=xf(w2ls),
        inf_dists=[d.to(device) for d in dists], inf_rows=tuple(inf_rows),
        inf_scale=torch.as_tensor(l_emit[list(inf_rows)].reshape(k, 3),
                                  dtype=torch.float32, device=device),
        inf_flat=torch.as_tensor(flat, device=device),
        inf_desc=torch.as_tensor(desc, device=device),
        row_inf=torch.as_tensor(row_inf, device=device))


@dataclasses.dataclass
class LightSample:
    wi: torch.Tensor          # (B, 3)
    li: torch.Tensor          # (B, 3)
    pdf: torch.Tensor         # (B,) solid-angle pdf
    p_target: torch.Tensor    # (B, 3) point for the shadow ray
    n_target: torch.Tensor    # (B, 3)
    err_target: torch.Tensor  # (B, 3)
    # (B,) bool, or None where the scene has no such light: a point or
    # distant light (MIS weight 1), a direction probe (distant, infinite)
    is_delta: Optional[torch.Tensor] = None
    at_infinity: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# area lights: triangles, quadrics, the sphere's cone
# ---------------------------------------------------------------------------

def _sample_quadric(lt: LightTables, lid, u, kinds):
    """Uniform-area sample of the quadric of area-light rows ``lid``: the
    z- and phi-clipped sphere by Archimedes (z uniform in [z_min, z_max],
    phi in [0, phi_max]: uniform in area; the reference's deliberate
    departure from sampling the whole sphere), the disk concentrically,
    the cylinder in (z, phi). -> (p, n, err) world space."""
    q_type, qp = lt.l_q_type[lid], lt.l_q_params[lid]
    radius = qp[:, 0]
    parts = {}
    if kinds & {"sphere", "cylinder"}:
        z = qp[:, 1] + u[:, 0] * (qp[:, 2] - qp[:, 1])
        phi = u[:, 1] * qp[:, 3]
    if "sphere" in kinds:
        zr = z / torch.clamp(radius, min=1e-8)
        s = torch.sqrt(torch.clamp(1.0 - zr * zr, min=0.0))
        n_obj = torch.stack([s * torch.cos(phi), s * torch.sin(phi), zr], -1)
        parts[SPHERE] = (radius[:, None] * n_obj, n_obj)
    if "cylinder" in kinds:
        c, s = torch.cos(phi), torch.sin(phi)
        parts[CYLINDER] = (torch.stack([radius * c, radius * s, z], -1),
                           torch.stack([c, s, torch.zeros_like(phi)], -1))
    if "disk" in kinds:
        d_xy = concentric_sample_disk(u) * qp[:, 1, None]
        n_obj = torch.tensor([0.0, 0.0, 1.0],
                             device=u.device).expand(u.shape[0], 3)
        parts[DISK] = (torch.cat([d_xy, qp[:, 0, None]], -1), n_obj)
    (obj, n_obj), *rest = [parts[k] for k in sorted(parts, reverse=True)]
    for k, (o_k, n_k) in zip(sorted(parts, reverse=True)[1:], rest):
        sel = (q_type == k)[:, None]
        obj, n_obj = torch.where(sel, o_k, obj), torch.where(sel, n_k, n_obj)
    p = xform_point(lt.l_q_o2w[lid], obj)
    n = normalize(xform_normal(lt.l_q_w2o[lid], n_obj))
    n = torch.where(lt.l_q_rev[lid][:, None], -n, n)
    return p, n, torch.abs(p) * 1e-5 + 1e-6


def _sphere_cone_geom(lt: LightTables, lid, ref_p):
    """The cone a full sphere light subtends from ref_p: -> (valid, centre,
    radius, centre - ref_p, its length and square, cos theta_max). The
    centre is the o2w translation, the radius the object-space one (the
    reference's no-scale assumption)."""
    r = lt.l_q_params[lid][:, 0]
    center = lt.l_q_o2w[lid][:, :3, 3]
    dvec = center - ref_p
    dc2 = torch.clamp(dot(dvec, dvec), min=1e-20)
    dc = torch.sqrt(dc2)
    valid = lt.l_cone[lid] & (dc2 > r * r)
    sin2max = torch.clamp(r * r / dc2, 0.0, 1.0)
    cosmax = torch.sqrt(torch.clamp(1.0 - sin2max, min=0.0))
    return valid, center, r, dvec, dc, dc2, cosmax


def _cone_pdf(cosmax):
    return 1.0 / torch.clamp(TWO_PI * (1.0 - cosmax), min=1e-9)


def cone_pdf_wi(lt: LightTables, lid, ref_p):
    """Solid-angle pdf of the cone strategy, 1 / (2 pi (1 - cos theta_max)),
    and where it applies (a full sphere seen from outside)."""
    valid, *_, cosmax = _sphere_cone_geom(lt, lid, ref_p)
    return torch.where(valid, _cone_pdf(cosmax), 0.0), valid


def _sphere_cone_sample(lt: LightTables, lid, ref_p, u):
    """Uniform solid-angle sample of the cone a full sphere subtends from
    ref_p: -> (valid, p, outward n (reversed with the light), err, pdf)."""
    valid, center, r, dvec, dc, dc2, cosmax = _sphere_cone_geom(lt, lid,
                                                                ref_p)
    cost = (1.0 - u[:, 0]) + u[:, 0] * cosmax
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = u[:, 1] * 2.0 * float(PI)
    ds = dc * cost - torch.sqrt(torch.clamp(r * r - dc2 * sint * sint,
                                            min=0.0))
    cosa = (dc2 + r * r - ds * ds) / torch.clamp(2.0 * dc * r, min=1e-12)
    cosa = torch.clamp(cosa, -1.0, 1.0)
    sina = torch.sqrt(torch.clamp(1.0 - cosa * cosa, min=0.0))
    wc = dvec / dc[:, None]
    wcx, wcy = coordinate_system(wc)
    n_s = (sina * torch.cos(phi))[:, None] * (-wcx) \
        + (sina * torch.sin(phi))[:, None] * (-wcy) + cosa[:, None] * (-wc)
    p_s = center + r[:, None] * n_s
    n_out = torch.where(lt.l_q_rev[lid][:, None], -n_s, n_s)
    pdf = torch.where(valid, _cone_pdf(cosmax), 0.0)
    return valid, p_s, n_out, torch.abs(p_s) * 1e-5 + 1e-6, pdf


def _sample_area(lt: LightTables, lid, p, u, emit, kinds):
    """Area rows: a point on the light (triangle, quadric, or the cone of a
    full sphere seen from outside) -> (wi, li, pdf, p_a, n_a, err_a)."""
    if "tri" in kinds:
        pts = lt.l_tri_p[lid]
        p_a, n_a, err_a = triangle_sample(u, pts[:, 0], pts[:, 1], pts[:, 2])
        n_a = torch.where(lt.l_tri_rev[lid][:, None], -n_a, n_a)
    if "quadric" in kinds:
        qp, qn, qerr = _sample_quadric(lt, lid, u, kinds)
        if "tri" in kinds:
            is_q = (lt.l_q_type[lid] >= 0)[:, None]
            p_a, n_a = torch.where(is_q, qp, p_a), torch.where(is_q, qn, n_a)
            err_a = torch.where(is_q, qerr, err_a)
        else:
            p_a, n_a, err_a = qp, qn, qerr
    if "cone" in kinds:
        c_valid, c_p, c_n, c_err, c_pdf = _sphere_cone_sample(lt, lid, p, u)
        cv = c_valid[:, None]
        p_a, n_a = torch.where(cv, c_p, p_a), torch.where(cv, c_n, n_a)
        err_a = torch.where(cv, c_err, err_a)
    d_a = p_a - p
    dist2 = torch.clamp(dot(d_a, d_a), min=1e-12)
    wi = d_a * torch.rsqrt(torch.clamp(dist2, min=1e-20))[:, None]
    cos_l = dot(n_a, -wi)
    facing = torch.where(lt.l_twosided[lid], torch.abs(cos_l) > 1e-7,
                         cos_l > 1e-7)
    li = torch.where(facing[:, None], emit, 0.0)
    pdf = dist2 / torch.clamp(torch.abs(cos_l) * lt.l_area[lid], min=1e-12)
    if "cone" in kinds:
        pdf = torch.where(c_valid, c_pdf, pdf)
    pdf = torch.where(facing, pdf, 0.0)
    return wi, li, pdf, p_a, n_a, err_a


# ---------------------------------------------------------------------------
# infinite lights (K15, K16)
# ---------------------------------------------------------------------------

def _inf_uv_to_dir(lt: LightTables, k, uv):
    theta = uv[:, 1] * float(PI)
    phi = uv[:, 0] * 2.0 * float(PI)
    st, ct = torch.sin(theta), torch.cos(theta)
    w_l = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    return xform_vector(lt.inf_l2w[k], w_l), st


def _inf_dir_to_uv(lt: LightTables, k, w):
    w_l = normalize(xform_vector(lt.inf_w2l[k], w))
    theta = spherical_theta(w_l)
    phi = spherical_phi(w_l)
    return torch.stack([phi / TWO_PI, theta / float(PI)], -1), \
        torch.sin(theta)


def _inf_pdf(map_pdf, sin_t):
    pdf = map_pdf / torch.clamp(INF_PDF_SCALE * sin_t, min=1e-9)
    return torch.where(sin_t > 1e-7, pdf, 0.0)


def infinite_sample_plain(lt: LightTables, lid, p, u):
    """Plain version of K15: for each lane whose row ``lid`` is infinite
    light k, the 2D distribution's sample of u (the marginal's and the row's
    find_interval), its direction through l2w, pdf = map pdf / (2 pi^2 sin
    theta) (0 where sin theta <= 1e-7), Le = the map's bilinear value
    (REPEAT) times the light's scale, and the target p + 2 world_radius wi;
    zeros on the other lanes. -> (wi, pdf, li, p_target)."""
    n = lid.shape[0]
    wi = torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    pdf, li, pt = wi[:, 0].clone(), wi.clone(), wi.clone()
    emit = lt.l_emit[lid.long()]
    for k, row in enumerate(lt.inf_rows):
        mine = lid == row
        uv, map_pdf = lt.inf_dists[k].sample_continuous(u)
        wi_k, sin_t = _inf_uv_to_dir(lt, k, uv)
        li_k = bilerp_level(lt.inf_maps[k], uv, WRAP_REPEAT) * emit
        m3 = mine[:, None]
        wi = torch.where(m3, wi_k, wi)
        pdf = torch.where(mine, _inf_pdf(map_pdf, sin_t), pdf)
        li = torch.where(m3, li_k, li)
        pt = torch.where(m3, p + wi_k * (2.0 * lt.world_radius), pt)
    return wi, pdf, li, pt


def infinite_sample(lt: LightTables, lid, p, u):
    """K15 (csrc/lights.cu): ``infinite_sample_plain``'s outputs. CPU
    tensors take the plain version, CUDA tensors launch the kernel."""
    if not cuda.use_kernel(p):
        return infinite_sample_plain(lt, lid, p, u)
    n, dev = p.shape[0], p.device
    cuda.check(lid, "lid", torch.int32, (n,), dev)
    cuda.check(p, "p", torch.float32, (n, 3), dev)
    cuda.check(u, "u", torch.float32, (n, 2), dev)
    _check_inf_tables(lt, dev)
    wi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty(n, dtype=torch.float32, device=dev)
    li, pt = torch.empty_like(wi), torch.empty_like(wi)
    if n:
        cuda.launch("infinite_sample", lid, p, u, n, lt.row_inf,
                    lt.n_lights, lt.l_emit, lt.inf_flat, lt.inf_desc,
                    lt.inf_l2w, lt.world_radius, wi, pdf, li, pt)
    return wi, pdf, li, pt


def _check_inf_tables(lt: LightTables, dev):
    k, n_l = lt.n_infinite, lt.n_lights
    cuda.check(lt.row_inf, "row_inf", torch.int32, (n_l,), dev)
    cuda.check(lt.inf_scale, "inf_scale", torch.float32, (k, 3), dev)
    cuda.check(lt.l_emit, "l_emit", torch.float32, (n_l, 3), dev)
    cuda.check(lt.inf_flat, "inf_flat", torch.float32,
               tuple(lt.inf_flat.shape), dev)
    cuda.check(lt.inf_desc, "inf_desc", torch.int32, (k, len(INF_DESC)),
               dev)
    for t, name in ((lt.inf_l2w, "inf_l2w"), (lt.inf_w2l, "inf_w2l")):
        cuda.check(t, name, torch.float32, (k, 4, 4), dev)


def infinite_escape_plain(lt: LightTables, d, mask, prev_pdf=None,
                          prev_spec=None, pmfs=None):
    """Plain version of K16: the radiance of escaped rays d (B, 3), summed
    over the scene's infinite lights in order, 0 where ``mask`` is False.
    Without ``prev_pdf`` (camera rays) each light adds its Le (the map's
    bilinear value at d's uv through w2l, times its scale); else Le times
    the power heuristic of ``prev_pdf`` against light k's pdf at d times
    its selection pmf ``pmfs[k]`` (a number or (B,)), weight 1 where
    ``prev_spec``."""
    out = torch.zeros((d.shape[0], 3), dtype=torch.float32, device=d.device)
    for k, row in enumerate(lt.inf_rows):
        uv, sin_t = _inf_dir_to_uv(lt, k, d)
        le = bilerp_level(lt.inf_maps[k], uv, WRAP_REPEAT) * lt.l_emit[row]
        if prev_pdf is None:
            out = out + le
            continue
        light_pdf = _inf_pdf(lt.inf_dists[k].pdf(uv), sin_t) * pmfs[k]
        w = torch.where(prev_spec, 1.0,
                        power_heuristic(1.0, prev_pdf, 1.0, light_pdf))
        out = out + w[:, None] * le
    return torch.where(mask[:, None], out, 0.0)


def infinite_escape(lt: LightTables, d, mask, prev_pdf=None, prev_spec=None,
                    pmfs=None):
    """K16 (csrc/lights.cu): ``infinite_escape_plain``'s radiance. CPU
    tensors take the plain version, CUDA tensors launch the kernel (the
    pmfs as one (K, B) table, or one number for all when each is the
    uniform pick's)."""
    if not cuda.use_kernel(d):
        return infinite_escape_plain(lt, d, mask, prev_pdf, prev_spec, pmfs)
    n, dev = d.shape[0], d.device
    cuda.check(d, "d", torch.float32, (n, 3), dev)
    cuda.check(mask, "mask", torch.bool, (n,), dev)
    _check_inf_tables(lt, dev)
    mis = prev_pdf is not None
    pmf_tab, pmf_const = None, 0.0
    if mis:
        cuda.check(prev_pdf, "prev_pdf", torch.float32, (n,), dev)
        cuda.check(prev_spec, "prev_spec", torch.bool, (n,), dev)
        if all(not isinstance(x, torch.Tensor) for x in pmfs):
            if len(set(pmfs)) > 1:
                raise ValueError("K16 takes one uniform pmf for all lights")
            pmf_const = float(pmfs[0])
        else:
            pmf_tab = torch.stack([x if isinstance(x, torch.Tensor)
                                   else torch.full((n,), float(x),
                                                   device=dev)
                                   for x in pmfs]).contiguous()
            cuda.check(pmf_tab, "pmfs", torch.float32, (lt.n_infinite, n),
                       dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        cuda.launch("infinite_escape", d, mask, prev_pdf, prev_spec,
                    pmf_tab, pmf_const, int(mis), n, lt.n_infinite,
                    lt.inf_scale, lt.inf_flat, lt.inf_desc, lt.inf_w2l, out)
    return out


def infinite_le(lt: LightTables, d, mask=None):
    """Radiance of escaped rays (B, 3): the sum over the scene's infinite
    lights (K16's camera-ray form)."""
    if mask is None:
        mask = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    return infinite_escape(lt, d, mask)


def infinite_le_mis(lt: LightTables, d, prev_pdf, prev_spec, pmfs,
                    mask=None):
    """MIS-weighted escape radiance: each infinite light's Le weighted by
    the power heuristic against its light-sampling density at d (its pdf
    times its selection pmf ``pmfs[k]`` at the scattering point); weight 1
    after a specular bounce (K16)."""
    if mask is None:
        mask = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    return infinite_escape(lt, d, mask, prev_pdf, prev_spec, pmfs)


# ---------------------------------------------------------------------------
# sample_li / pdf_li_hit / Le
# ---------------------------------------------------------------------------

def _pick(ltype, cases):
    """The value of each lane's light type: ``cases`` (type, (B, ...))."""
    out = cases[0][1]
    for code, v in cases[1:]:
        c = ltype == code
        out = torch.where(c if v.dim() == 1 else c[:, None], v, out)
    return out


def row_kinds(lt: LightTables, j: int) -> frozenset:
    """``kinds`` of light row j alone."""
    t, qt = int(lt.l_type[j]), int(lt.l_q_type[j])
    return _kinds(np.array([t]), np.array([qt]),
                  np.array([bool(lt.l_cone[j])]))


def sample_li(lt: LightTables, lid, si, u, kinds=None) -> LightSample:
    """Sample an incident direction from light row ``lid`` (B,) seen from
    si.p with u (B, 2): every type the scene holds (or ``kinds``, a caller
    whose lanes all take rows of those kinds), each lane taking its row's
    type."""
    lid = lid.long()
    kinds = lt.kinds if kinds is None else kinds
    p = si.p
    emit = lt.l_emit[lid]
    cases = {k: [] for k in ("wi", "li", "pdf", "pt", "nt", "err")}

    def add(code, wi, li, pdf, pt, nt, err):
        for key, v in zip(cases, (wi, li, pdf, pt, nt, err)):
            cases[key].append((code, v))

    if kinds & {"tri", "quadric"}:
        wi, li, pdf, p_a, n_a, err_a = _sample_area(lt, lid, p, u, emit,
                                                    kinds)
        add(LIGHT_AREA, wi, li, pdf, p_a, n_a, err_a)
    zero3 = None
    if kinds & {"point", "distant", "infinite", "dummy"}:
        zero3 = torch.zeros_like(p)
        ones = torch.ones_like(p[:, 0])
    pos = lt.l_pos[lid] if kinds & {"point", "distant"} else None
    if "point" in kinds:
        d_pt = pos - p
        dist2 = torch.clamp(dot(d_pt, d_pt), min=1e-12)
        wi = d_pt * torch.rsqrt(torch.clamp(dist2, min=1e-20))[:, None]
        add(LIGHT_POINT, wi, emit / dist2[:, None], ones, pos, -wi, zero3)
    if "distant" in kinds:
        add(LIGHT_DISTANT, pos, emit, ones,
            p + pos * (2.0 * lt.world_radius), -pos, zero3)
    if "infinite" in kinds:
        wi, pdf, li, pt = infinite_sample(lt, lid.int(), p.contiguous(),
                                          u.contiguous())
        add(LIGHT_INFINITE, wi, li, pdf, pt, -wi, zero3)
    if not cases["wi"]:    # only the dummy row
        z1 = torch.zeros_like(p[:, 0])
        return LightSample(wi=zero3, li=zero3, pdf=z1, p_target=zero3,
                           n_target=zero3, err_target=zero3)
    ltype = None if kinds <= {"tri", "quadric", "sphere", "cylinder",
                              "disk", "cone"} else lt.l_type[lid]
    out = {key: (v[0][1] if len(v) == 1 else _pick(ltype, v))
           for key, v in cases.items()}
    is_delta = at_inf = None
    if kinds & {"point", "distant"}:
        is_delta = (ltype == LIGHT_POINT) | (ltype == LIGHT_DISTANT)
    if kinds & {"distant", "infinite"}:
        at_inf = (ltype == LIGHT_DISTANT) | (ltype == LIGHT_INFINITE)
    if "dummy" in kinds:    # the dummy row emits nothing
        out["li"] = torch.where((ltype >= 0)[:, None], out["li"], 0.0)
        out["pdf"] = torch.where(ltype >= 0, out["pdf"], 0.0)
    return LightSample(wi=out["wi"], li=out["li"], pdf=out["pdf"],
                       p_target=out["pt"], n_target=out["nt"],
                       err_target=out["err"], is_delta=is_delta,
                       at_infinity=at_inf)


def pdf_li_hit(lt: LightTables, lid, prev_p, d, p_hit, n_hit):
    """Solid-angle pdf with which sample_li at prev_p picks the direction d
    toward the known hit (p_hit, n_hit) on area-light row lid (-1: none):
    the area density, or the cone's for a full sphere seen from outside."""
    lid_c = lid.clamp(0, lt.n_lights - 1).long()
    area = lt.l_area[lid_c]
    dist2 = torch.clamp(distance_squared(prev_p, p_hit), min=1e-12)
    cos_l = absdot(n_hit, d)
    pdf = dist2 / torch.clamp(cos_l * area, min=1e-12)
    pdf = torch.where((lid >= 0) & (cos_l > 1e-7), pdf, 0.0)
    if "cone" in lt.kinds:
        cpdf, cvalid = cone_pdf_wi(lt, lid_c, prev_p)
        pdf = torch.where((lid >= 0) & cvalid, cpdf, pdf)
    return pdf


def arealight_le(lt: LightTables, arealight_id, n, w):
    """Radiance an area light's surface emits toward w."""
    lid = arealight_id.clamp(0, lt.n_lights - 1).long()
    ok = (arealight_id >= 0) & (lt.l_twosided[lid] | (dot(n, w) > 0.0))
    return torch.where(ok[:, None], lt.l_emit[lid], 0.0)
