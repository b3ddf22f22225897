"""Inputs and bounds of K14 (the quadrics' hit search) and of K2's quadric
branch; shared by chip_smoke.py and the tests.

- ``quadric_table``: a seeded table of 16 mixed quadrics (full, z- and
  phi-clipped spheres, cylinders, disks with an inner radius; rotated,
  non-uniformly scaled, translated and reverse-oriented transforms), the
  numpy ``quadrics`` dict of ``scene.tables.make_geometry``;
  ``table_geometry`` puts it over a ground triangle.
- ``quadric_rays``: seeded rays at such a table: most aimed near a
  quadric's centre from outside, some from inside one, some anywhere.
- ``k14_work`` / ``k14_bound``: K14's bound on a call's data, the larger of
  its bytes (each ray read once, its outputs written once, the tables read
  once) over PEAK_BYTES_PER_S and its operations over PEAK_OPS_PER_S,
  counted from the data (``test_ops``): every lane x quadric pair the
  search reaches pays the transform, the quadratic (or the disk's plane
  hit) and the range tests of its roots; a root's point and clip tests
  only where the root lies in (0, t_max), and atan2f only where the z (or
  the disk's radius) test passes. The closest search reaches every pair,
  each with the best t so far as t_max; the any-hit search a lane's
  quadrics up to its first hit.
- ``k2_bound``: K2's bound on a call's data, its triangle and quadric lanes
  counted apart.
- ``capture_quadric_step``: the inputs of the first (or of every) K14
  closest, K14 any and K2 call of one renderer step; ``inside_sphere``:
  the lanes of a call whose rays start inside a sphere (refracted rays
  leaving a glass ball), ``inside_counts`` their count in each recorded
  call.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.math import quadratic
from ..core.ray import Ray
from ..core.transform import Transform
from ..ops.quadrics import CYLINDER, DISK, FULL_PHI, SPHERE, quadric_hit_t
from ..scene.tables import quadric_object_ray
from .traverse_work import PEAK_BYTES_PER_S, PEAK_OPS_PER_S

# float32 operations, each one instruction under -fmad=false (atan2f
# counted at ATAN2_OPS, CUDA's polynomial with its range reduction):
# the ray into object space (rows 0-2 of w2o: 18 products, 15 sums)
TRANSFORM_OPS = 33
ATAN2_OPS = 25
# phi: atan2f, the wrap (a compare, an add) and the phi_max compare
PHI_OPS = ATAN2_OPS + 3
# the best-hit update of the closest search (a compare, two selects)
BEST_OPS = 3
# a quadratic's two roots: each root's has-roots test on every lane, its
# t > 0 and t < t_max tests where the discriminant is non-negative
ROOT_HAS_OPS = 1
ROOT_RANGE_OPS = 2
# a sphere's a, b, c 18 and the quadratic 15; a clipped sphere's root in
# range: the point 6, its reprojection 8 and scale 3, the pole nudge 4,
# the z compares 2 (a full sphere's hit needs no point)
SPHERE_BASE_OPS = 18 + 15
SPHERE_ROOT_OPS = 23
# a cylinder's a, b, c and the a == 0 guard 13, the quadratic 15; a root
# in range: the point 6, the z compares 2
CYLINDER_BASE_OPS = 13 + 15
CYLINDER_ROOT_OPS = 8
# a disk's parallel test 2, t 3, the range tests 3; t in range: the point
# 4, dist2 3, the radii's squares and compares 4
DISK_BASE_OPS = 8
DISK_ROOT_OPS = 11
TABLE_WORDS = 17          # a quadric's type, rows 0-2 of w2o, parameters
RAY_IN_BYTES = 12 + 12 + 4
# K2 a lane: the rays, hits and ids in (37 bytes), 11 vector fields, uv
# and 3 ids out (152 bytes); the operations of a triangle lane (chip_smoke
# LANE_OPS) and of a quadric lane (the object ray 41, the full hit of its
# type with acosf x 3 and sinf about 260, p, its error, dpdu, dpdv, the
# normal and its derivatives through the two matrices about 150, the
# shading frame 30)
K2_LANE_BYTES = 37 + 11 * 12 + 8 + 12
K2_TRI_OPS = 300
K2_QUADRIC_OPS = 480
# a distinct hit's table row: a triangle's t_shade row, a quadric's
# o2w, w2o, parameters, type, material, area light and reverse flag
K2_TRI_ROW_BYTES = 32 * 4
K2_QUADRIC_ROW_BYTES = (16 + 16 + 4 + 4) * 4


def quadric_table(seed=11) -> dict:
    """16 quadrics (see the module docstring) as make_geometry's numpy
    ``quadrics`` dict; materials 0-3, no area light."""
    rs = np.random.RandomState(seed)
    rows = [  # (type, params, rotation axis and degrees, scale, reverse)
        (SPHERE, (1.0, -1.0, 1.0, 2 * np.pi), None, (1, 1, 1), False),
        (SPHERE, (0.8, -0.3, 0.6, 2 * np.pi), (1, 0, 0, 35), (1, 1, 1), False),
        (SPHERE, (0.7, -0.7, 0.7, np.deg2rad(270)), (0, 1, 1, 60), (1, 1, 1),
         True),
        (SPHERE, (0.6, -0.6, 0.2, np.deg2rad(200)), (1, 1, 0, 20),
         (1.5, 1.0, 0.8), False),
        (CYLINDER, (0.5, -1.0, 1.0, 2 * np.pi), (1, 0, 0, 90), (1, 1, 1),
         False),
        (CYLINDER, (0.4, -0.5, 0.8, np.deg2rad(180)), (0, 0, 1, 45),
         (1, 1, 1), True),
        (CYLINDER, (0.6, -0.4, 0.4, np.deg2rad(300)), (1, 0, 1, 70),
         (0.7, 1.2, 1.0), False),
        (DISK, (0.0, 1.0, 0.3, 2 * np.pi), (1, 0, 0, -90), (1, 1, 1), False),
        (DISK, (0.2, 0.8, 0.0, np.deg2rad(300)), (0, 1, 0, 30), (1, 1, 1),
         True),
        (DISK, (-0.1, 0.9, 0.45, np.deg2rad(120)), (1, 1, 1, 50),
         (1.3, 0.9, 1.0), False),
        (SPHERE, (0.5, -0.5, 0.5, 2 * np.pi), None, (1, 1, 1), True),
        (SPHERE, (0.9, -0.2, 0.9, 2 * np.pi), (0, 0, 1, 80), (1, 1, 1),
         False),
        (CYLINDER, (0.3, 0.0, 1.5, 2 * np.pi), None, (1, 1, 1), False),
        (DISK, (0.0, 0.6, 0.0, 2 * np.pi), (0, 1, 0, 90), (1, 1, 1), False),
        (SPHERE, (1.2, -1.2, 0.0, np.deg2rad(90)), (1, 0, 0, 120), (1, 1, 1),
         False),
        (CYLINDER, (0.8, -0.2, 0.2, np.deg2rad(45)), (0, 1, 0, 10),
         (1, 1, 1), True),
    ]
    centres = rs.uniform(-4.0, 4.0, (len(rows), 3))
    q = {k: [] for k in ("q_type", "q_o2w", "q_w2o", "q_params",
                         "q_material", "q_reverse")}
    for i, (qt, params, rot, scale, rev) in enumerate(rows):
        o2w = Transform.translate(*centres[i])
        if rot is not None:
            o2w = o2w * Transform.rotate(rot[3], *rot[:3])
        o2w = o2w * Transform.scale(*scale)
        q["q_type"].append(qt)
        q["q_o2w"].append(o2w.m)
        q["q_w2o"].append(o2w.m_inv)
        q["q_params"].append(params)
        q["q_material"].append(i % 4)
        q["q_reverse"].append(rev ^ o2w.swaps_handedness())
    return dict(q_type=np.array(q["q_type"], np.int32),
                q_o2w=np.stack(q["q_o2w"]).astype(np.float32),
                q_w2o=np.stack(q["q_w2o"]).astype(np.float32),
                q_params=np.array(q["q_params"], np.float32),
                q_material=np.array(q["q_material"], np.int32),
                q_arealight=np.full(len(rows), -1, np.int32),
                q_reverse=np.array(q["q_reverse"], bool))


def table_geometry(table: dict, device="cpu"):
    """``table``'s quadrics over one ground triangle (material 0, below
    every quadric: the lanes that miss them take the triangle branch) ->
    scene.tables.GeometryTables on ``device``."""
    from ..scene.tables import make_geometry
    ground = np.array([[-9, -5, -9], [9, -5, -9], [0, -5, 9]], np.float32)
    tris = dict(tv_p=ground, tv_n=np.zeros_like(ground),
                tv_uv=np.zeros((3, 2), np.float32),
                tv_s=np.zeros_like(ground),
                t_idx=np.arange(3, dtype=np.int32)[None],
                t_material=np.zeros(1, np.int32),
                t_arealight=np.full(1, -1, np.int32),
                t_reverse=np.zeros(1, bool), t_has_n=np.zeros(1, bool),
                t_has_uv=np.zeros(1, bool))
    return make_geometry(tris, quadrics=table, device=device)


def quadric_rays(table: dict, n: int, seed=7, device="cpu") -> Ray:
    """n rays (t_max INF) at ``table``'s quadrics: 70% from 6-10 units out
    aimed within 1.2 units of a quadric's centre, 15% from within 0.3 of
    a centre in a random direction (inside or near a surface), 15% from
    anywhere in the scene's box in a random direction."""
    rs = np.random.RandomState(seed)
    centres = table["q_o2w"][:, :3, 3].astype(np.float64)
    pick = centres[rs.randint(0, len(centres), n)]
    kind = rs.uniform(0, 1, n)
    rand_dir = rs.normal(size=(n, 3))
    away = rs.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    aimed = kind < 0.7
    inside = (kind >= 0.7) & (kind < 0.85)
    o = rs.uniform(-6.0, 6.0, (n, 3))
    o[aimed] = pick[aimed] + away[aimed] * rs.uniform(6, 10, (n, 1))[aimed]
    o[inside] = pick[inside] + rs.uniform(-0.3, 0.3, (n, 3))[inside]
    d = rand_dir
    target = pick + rs.uniform(-1.2, 1.2, (n, 3))
    d[aimed] = (target - o)[aimed]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=device)
    return Ray(o=t(o), d=t(d), t_max=torch.full((n,), float("inf"),
                                                 device=device))


def test_ops(q_type: int, params, oc, dc, t_max):
    """-> (B,) int64: the operations of quadric type ``q_type``'s (t, hit)
    test (params its (4,) row) on each lane's object-space ray (oc, dc:
    component triples, ``quadric_object_ray``) below ``t_max``, counted
    from the lane's data with the plain tests' float32 arithmetic (see the
    module docstring; the transform and the best-hit update not
    included)."""
    ox, oy, oz = oc
    dx, dy, dz = dc
    if q_type == DISK:
        height, radius, inner = params[0], params[1], params[2]
        parallel = torch.abs(dz) < 1e-12
        t = (height - oz) / torch.where(parallel, 1.0, dz)
        live = ~parallel & (t > 0.0) & (t < t_max)
        px, py = ox + t * dx, oy + t * dy
        dist2 = px * px + py * py
        ring = live & (dist2 <= radius * radius) & (dist2 >= inner * inner)
        return DISK_BASE_OPS + DISK_ROOT_OPS * live.long() \
            + PHI_OPS * ring.long()
    radius, z_min, z_max, phi_max = params[0], params[1], params[2], \
        params[3]
    if q_type == CYLINDER:
        a = dx * dx + dy * dy
        b = 2.0 * (dx * ox + dy * oy)
        c = ox * ox + oy * oy - radius * radius
        t0, t1, has = quadratic(torch.where(a == 0.0, 1e-20, a), b, c)
        has = has & (a > 0.0)
        ops, root_ops, full = CYLINDER_BASE_OPS, CYLINDER_ROOT_OPS, False
    else:
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (ox * dx + oy * dy + oz * dz)
        c = ox * ox + oy * oy + oz * oz - radius * radius
        t0, t1, has = quadratic(a, b, c)
        ops, root_ops = SPHERE_BASE_OPS, SPHERE_ROOT_OPS
        full = bool((phi_max >= FULL_PHI) & (z_min <= -radius)
                    & (z_max >= radius))
    ops = ops + 2 * ROOT_HAS_OPS + torch.zeros_like(has, dtype=torch.int64)
    for t in (t0, t1):
        ops = ops + ROOT_RANGE_OPS * has.long()
        live = has & (t > 0.0) & (t < t_max)
        if full:
            continue
        pz = oz + t * dz
        if q_type != CYLINDER:
            px, py = ox + t * dx, oy + t * dy
            pz = pz * (radius / torch.clamp(torch.sqrt(
                px * px + py * py + pz * pz), min=1e-20))
        z_ok = live & (pz >= z_min) & (pz <= z_max)
        ops = ops + root_ops * live.long() + PHI_OPS * z_ok.long()
    return ops


def k14_work(geom, o, d, t_max, any_hit: bool) -> dict:
    """-> dict(lanes, tests, ops, moved): the quadric tests a call does on
    its data (every quadric on every lane for the closest search, each
    with the best t so far as its t_max; up to a lane's first hit for the
    any-hit search), their operations counted from the data (``test_ops``
    with the plain tests) and the bytes the call must move."""
    types = geom.q_type.tolist()
    n = o.shape[0]
    t_lim = t_max.clone()
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    tests = ops = 0
    for i, qt in enumerate(types):
        oc, dc = quadric_object_ray(geom, i, o, d)
        per_lane = TRANSFORM_OPS + (0 if any_hit else BEST_OPS) \
            + test_ops(qt, geom.q_params[i], oc, dc, t_lim)
        tests += int(alive.sum())
        ops += int(per_lane[alive].sum())
        t, hit = quadric_hit_t(qt, oc, dc, t_lim, geom.q_params[i])
        if any_hit:
            alive &= ~hit
        else:
            t_lim = torch.where(hit & (t < t_lim), t, t_lim)
    out_bytes = 1 if any_hit else 1 + 4 + 4
    moved = n * (RAY_IN_BYTES + out_bytes) + len(types) * TABLE_WORDS * 4
    return dict(lanes=n, tests=tests, ops=ops, moved=moved)


def _bound(moved, ops):
    """-> (bound_ms, "bytes" or "operations")."""
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k14_bound(work: dict):
    return _bound(work["moved"], work["ops"])


def k2_bound(geom, hit, prim):
    """K2's bound on a call: every lane's bytes, each distinct hit's row,
    and the operations of its triangle and quadric hit lanes. -> (bound_ms,
    bound_by, n quadric lanes, n triangle lanes)."""
    nq = geom.n_quadrics
    quad = hit & (prim < nq)
    tri = hit & (prim >= nq)
    nqd, ntr = int(quad.sum()), int(tri.sum())
    rows_q = torch.unique(prim[quad]).numel()
    rows_t = torch.unique(prim[tri]).numel()
    moved = hit.shape[0] * K2_LANE_BYTES + rows_q * K2_QUADRIC_ROW_BYTES \
        + rows_t * K2_TRI_ROW_BYTES
    ms, by = _bound(moved, nqd * K2_QUADRIC_OPS + ntr * K2_TRI_OPS)
    return ms, by, nqd, ntr


@contextlib.contextmanager
def record_calls(module, name, into, every):
    """Within the scope, the first call (``every``: each call, in order)
    of ``module.name`` stores its arguments, tensors cloned, under
    ``into[name]`` (``every``: a list of them)."""
    orig = getattr(module, name)

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, Ray):
            return Ray(o=x.o.clone(), d=x.d.clone(), t_max=x.t_max.clone())
        return x

    def recorded(*args):
        if every:
            into.setdefault(name, []).append(tuple(clone(a) for a in args))
        else:
            into.setdefault(name, tuple(clone(a) for a in args))
        return orig(*args)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_quadric_step(renderer, ctx, tile, sample=1, every=False) -> dict:
    """One step of ``tile`` at ``sample`` -> the arguments of its first
    calls (``every``: lists of all its calls, in order) of scene/tables.py
    ``intersect_quadrics_all`` (K14 closest: geom, o, d, t_max; first the
    camera rays), ``quadrics_any_hit`` (K14 any: first the first shadow
    rays) and ``build_interaction`` (K2: geom, ray, hit, t, prim; first
    the camera rays' hits), under those names."""
    from ..scene import tables   # the module whose functions are wrapped
    calls = {}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with record_calls(tables, "intersect_quadrics_all", calls, every), \
            record_calls(tables, "quadrics_any_hit", calls, every), \
            record_calls(tables, "build_interaction", calls, every):
        renderer.step(ctx, fs, px, py, sample, v)
    return calls


def inside_counts(calls, key):
    """-> for each recorded call (``calls``: capture_quadric_step(every=
    True)'s list under ``key``), its live rays that start inside a sphere:
    build_interaction's quadric hits, or the K14 calls' rays with t_max >
    0."""
    counts = []
    for c in calls:
        if key == "build_interaction":
            geom, ray, hit, _, prim = c
            live = hit & (prim < geom.n_quadrics)
            o = ray.o
        else:
            geom, o, _, t_max = c
            live = t_max > 0
        counts.append(int((inside_sphere(geom, o) & live).sum()))
    return counts


def inside_sphere(geom, o):
    """(N,) bool: the origins o (N, 3) that lie inside one of ``geom``'s
    spheres (in its object space, x^2 + y^2 + z^2 < r^2): the rays that
    leave a sphere from inside."""
    inside = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    q_type = geom.q_type.tolist()
    for i in range(geom.n_quadrics if geom.has_quadrics else 0):
        if q_type[i] == SPHERE:
            (x, y, z), _ = quadric_object_ray(geom, i, o, o)
            inside |= x * x + y * y + z * z < geom.q_params[i, 0] ** 2
    return inside
