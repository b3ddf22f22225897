"""Port parity of the quadrics and the checkerboard texture against the JAX
package, on the CPU: ``core/math.py: quadratic``; each of the sphere,
cylinder and disk intersections (the full hit and the (t, hit) test K14
runs) on full, z-clipped, phi-clipped and inner-radius cases with rays
from outside, from inside and missing; ``intersect_quadrics_all`` on 1, 2
and 5 quadrics (the reference's unrolled path and its fori_loop) with
transforms and a tie; ``closest_prim`` and ``scene_intersect_p`` on the
parsed testball-matte scene (a sphere over triangles);
``build_interaction`` on quadric lanes of every type;
``CheckerboardTexture``; and the bundle of ``scenes/testball-matte.pbrt``
parsed by both packages.

Inputs are seeded numpy arrays handed to both packages. Tolerances: hit
flags, quadric and prim ids and material ids bit-equal; t within 1e-6
relative plus the discriminant's rounding carried to t (``t_tolerance``:
XLA on the CPU contracts the quadratic's products into FMAs, PyTorch
rounds each, and a near-tangent ray's cancelling discriminant magnifies
the last-bit difference); the interaction's float fields within
1e-5 absolute or relative (atan2, acos and sin round differently in XLA
and in PyTorch; the normalisations too), p_error within 1e-5 relative;
the checkerboard within 1e-6; the bundle's tables bit-equal."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core.math import quadratic as jax_quadratic
from rustracer_tpu.core.ray import make_ray
from rustracer_tpu.ops import quadrics as JQ
from rustracer_tpu.scene import tables as JT
from rustracer_tpu.scene.api import parse_scene as jax_parse
from rustracer_tpu.scene.textures import CheckerboardTexture as JaxChecker
from rustracer_tpu.scene.textures import ConstantTexture as JaxConst
from rustracer_tpu.scene.textures import UVMapping2D as JaxUV
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.math import quadratic
from rustracer_tpu_torch.core.ray import Ray
from rustracer_tpu_torch.ops import quadrics as PQ
from rustracer_tpu_torch.scene import tables as PT
from rustracer_tpu_torch.scene.api import parse_scene
from rustracer_tpu_torch.scene.textures import (CheckerboardTexture,
                                                ConstantTexture, UVMapping2D)
from rustracer_tpu_torch.tools.quadric_work import quadric_rays, quadric_table

from test_torch_scene_api import assert_bundles_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTBALL = os.path.join(REPO, "scenes", "testball-matte.pbrt")
N = 4096
FIELDS = ("p", "p_error", "uv", "dpdu", "dpdv")


def close(a, b, tol=1e-5, msg=""):
    """a within tol absolute or relative of b, p_error (msg) within tol
    relative alone."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=msg)
    d = np.where(fin, np.abs(a - np.where(fin, b, 0.0)), 0.0)
    bad = d > tol * np.abs(b) + 1e-30
    if msg != "p_error":
        bad &= d > tol
    assert not bad.any(), f"{msg}: {int(bad.sum())} off, max {d.max()}"


EPS = float(np.finfo(np.float32).eps)


def t_tolerance(q_type, params, o, d):
    """Per-lane bound on |t - t_ref| for rays (o, d) in the quadric's
    object space: 1e-6 |t| plus the discriminant's rounding (16 eps of its
    terms' magnitudes, FMA or not) carried through sqrt and the divide by
    2a, which a near-tangent ray's cancelling discriminant magnifies. A
    disk's t is one divide: 1e-6 |t| only."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    if q_type == PQ.DISK:
        return np.zeros(len(o))
    r = float(params[0])
    if q_type == PQ.CYLINDER:
        o, d = o[:, :2], d[:, :2]
    a = (d * d).sum(1)
    b = 2.0 * (o * d).sum(1)
    c = (o * o).sum(1) - r * r
    scale = b * b + 4.0 * a * ((o * o).sum(1) + r * r)
    root = np.sqrt(np.maximum(b * b - 4.0 * a * c, scale * EPS))
    return 16.0 * EPS * scale / (4.0 * a * root)


def assert_t_close(t, ref, extra=0.0):
    err = np.abs(t - ref)
    tol = 1e-6 * np.abs(ref) + extra
    assert (err <= tol).all(), (int((err > tol).sum()), err.max())


def object_rays(q, qid, o, d):
    """World rays (o, d) in the object space of quadric qid of table q."""
    m = q["q_w2o"][qid].astype(np.float64)
    return ((m[:, :3, :3] @ o[:, :, None])[..., 0] + m[:, :3, 3],
            (m[:, :3, :3] @ d[:, :, None])[..., 0])


def world_t_tolerance(q, qid, o, d):
    ob, db = object_rays(q, qid, o, d)
    tol = np.zeros(len(o))
    for k in range(len(q["q_type"])):
        sel = qid == k
        if sel.any():
            tol[sel] = t_tolerance(q["q_type"][k], q["q_params"][k],
                                   ob[sel], db[sel])
    return tol


def test_quadratic():
    rs = np.random.RandomState(0)
    a = rs.uniform(0.1, 3.0, N).astype(np.float32)
    b = rs.uniform(-5.0, 5.0, N).astype(np.float32)
    c = rs.uniform(-3.0, 3.0, N).astype(np.float32)
    b[:16] = 0.0                       # q == 0 where c == 0 too
    c[:8] = 0.0
    jt0, jt1, jhas = (np.asarray(x) for x in jax_quadratic(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    t0, t1, has = quadratic(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    np.testing.assert_array_equal(has.numpy(), jhas)
    assert 0.2 < jhas.mean() < 0.95
    for x, y in ((t0, jt0), (t1, jt1)):
        np.testing.assert_allclose(x.numpy()[jhas], y[jhas], rtol=1e-6,
                                   atol=0)
    assert (t0.numpy() <= t1.numpy())[jhas].all()


CASES = {
    "sphere full": (PQ.SPHERE, (1.0, -1.0, 1.0, 2 * np.pi)),
    "sphere z-clipped": (PQ.SPHERE, (1.0, -0.4, 0.7, 2 * np.pi)),
    "sphere phi-clipped": (PQ.SPHERE, (1.0, -1.0, 1.0, np.deg2rad(250))),
    "sphere both": (PQ.SPHERE, (0.9, -0.9, 0.3, np.deg2rad(120))),
    "cylinder full": (PQ.CYLINDER, (0.8, -1.0, 1.0, 2 * np.pi)),
    "cylinder clipped": (PQ.CYLINDER, (0.8, -0.5, 1.0, np.deg2rad(200))),
    "disk full": (PQ.DISK, (0.2, 1.0, 0.0, 2 * np.pi)),
    "disk inner radius": (PQ.DISK, (0.0, 1.0, 0.4, np.deg2rad(300))),
}


def _object_rays(seed):
    """Rays near the unit ball: a fifth from inside it, a twentieth in
    random directions (mostly misses), the rest aimed at it from outside;
    t_max INF but 0.5 on 64 lanes."""
    rs = np.random.RandomState(seed)
    o = rs.normal(size=(N, 3)) * 3.0
    o[:N // 5] = rs.uniform(-0.5, 0.5, (N // 5, 3))
    d = rs.uniform(-1.2, 1.2, (N, 3)) - o
    d[N // 5:N // 4] = rs.normal(size=(N // 4 - N // 5, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(N, np.inf, np.float32)
    t_max[-64:] = 0.5
    return o.astype(np.float32), d.astype(np.float32), t_max


@pytest.mark.parametrize("case", sorted(CASES))
def test_intersect_matches_jax(case):
    q_type, params = CASES[case]
    o, d, t_max = _object_rays(sorted(CASES).index(case))
    p = np.array(params, np.float32)
    jfn = (JQ.sphere_intersect, JQ.cylinder_intersect,
           JQ.disk_intersect)[q_type]
    pfn = (PQ.sphere_intersect, PQ.cylinder_intersect,
           PQ.disk_intersect)[q_type]
    jh = jfn(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
             *[jnp.float32(x) for x in p])
    ph = pfn(torch.tensor(o), torch.tensor(d), torch.tensor(t_max),
             *[torch.tensor(x) for x in p])
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    assert 0.15 < hit.mean() < 0.9
    assert hit[:N // 5].any() and not hit[N // 5:].all()
    tol = t_tolerance(q_type, p, o, d)
    assert_t_close(ph.t.numpy()[hit], np.asarray(jh.t)[hit], tol[hit])
    for f in FIELDS:
        close(getattr(ph, f).numpy()[hit], np.asarray(getattr(jh, f))[hit],
              msg=f)
    # the (t, hit) test of K14's loop
    comps = [tuple(x[:, i] for i in range(3)) for x in (o, d)]
    jt, jhit = JQ.quadric_hit_t(
        jnp.int32(q_type), tuple(map(jnp.asarray, comps[0])),
        tuple(map(jnp.asarray, comps[1])), jnp.asarray(t_max),
        jnp.asarray(p))
    pt, phit = PQ.quadric_hit_t(q_type, tuple(map(torch.tensor, comps[0])),
                                tuple(map(torch.tensor, comps[1])),
                                torch.tensor(t_max), torch.tensor(p))
    jhit = np.asarray(jhit)
    np.testing.assert_array_equal(phit.numpy(), jhit)
    assert_t_close(pt.numpy()[jhit], np.asarray(jt)[jhit], tol[jhit])


def _tables(n):
    """The first n rows of the 16-quadric table; with n = 5 row 4 repeats
    row 0 (a tie: the first of two equal hits wins)."""
    q = {k: v[:n].copy() for k, v in quadric_table().items()}
    if n == 5:
        for k in q:
            q[k][4] = q[k][0]
    return q


@pytest.mark.parametrize("n", [1, 2, 5])
def test_intersect_quadrics_all_matches_jax(n):
    q = _tables(n)
    jg = JT.make_geometry(quadrics={k: v.copy() for k, v in q.items()})
    g = PT.make_geometry(quadrics=q, device="cpu")
    assert g.n_quadrics == jg.n_quadrics == n and g.has_quadrics
    ray = quadric_rays(q, N, seed=n)
    jhit, jt, jqid = (np.asarray(x) for x in JT.intersect_quadrics_all(
        jg, make_ray(jnp.asarray(ray.o.numpy()), jnp.asarray(ray.d.numpy()))))
    hit, t, qid = PT.intersect_quadrics_all(g, ray.o, ray.d, ray.t_max)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(qid.numpy(), jqid)
    o, d = ray.o.numpy()[jhit], ray.d.numpy()[jhit]
    assert_t_close(t.numpy()[jhit], jt[jhit],
                   world_t_tolerance(q, jqid[jhit], o, d))
    assert np.isinf(t.numpy()[~jhit]).all() and (qid.numpy()[~jhit] == 0).all()
    assert 0.1 < jhit.mean() < 0.9
    np.testing.assert_array_equal(
        PT.quadrics_any_hit(g, ray.o, ray.d, ray.t_max).numpy(), jhit)
    if n == 5:
        assert (jqid == 0).any() and not (jqid == 4).any()


@pytest.fixture(scope="module")
def testball():
    """Both packages' parse of testball-matte and the port's tables
    converted from the JAX bundle."""
    jb = jax_parse(TESTBALL).scene
    pb = parse_scene(TESTBALL, device="cpu").scene
    return jb, pb, convert.geometry_from_jax(jb.geom, device="cpu")


def _scene_rays(seed):
    """Rays over the testball scene: from the camera's side towards the
    ball and the floor, and from the floor up (shadow-like, towards the
    light); t_max INF, or the distance to a point on the light."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-2.0, 2.0, (N, 3)) * [1.0, 0.0, 1.0] + [0.0, 1.7, -4.4]
    tgt = rs.uniform(-1.5, 1.5, (N, 3)) * [1.0, 0.8, 1.0] + [0.0, 0.6, 0.0]
    up = N // 2
    o[up:] = rs.uniform(-3.0, 3.0, (N - up, 3)) * [1.0, 0.0, 1.0] \
        + [0.0, 1e-3, 0.0]
    tgt[up:] = rs.uniform(-1.6, 1.6, (N - up, 3)) * [1.0, 0.0, 1.0] \
        + [0.0, 5.2, 0.0]
    d = (tgt - o).astype(np.float32)
    t_max = np.full(N, np.inf, np.float32)
    t_max[up:] = 0.999
    return o.astype(np.float32), d, t_max


def test_closest_prim_and_shadow_match_jax(testball):
    jb, _, g = testball
    o, d, t_max = _scene_rays(3)
    jray = make_ray(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    jhit, jt, jprim, _ = (np.asarray(x) for x in JT._closest_prim(jb.geom,
                                                                  jray))
    ray = Ray(o=torch.tensor(o), d=torch.tensor(d), t_max=torch.tensor(t_max))
    hit, t, prim = PT.closest_prim(g, ray)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(prim.numpy(), jprim)
    on_ball = jhit & (jprim < g.n_quadrics)
    q = {k: getattr(g, k).numpy() for k in PT.QUADRIC_KEYS}
    tol = np.zeros(N)
    tol[on_ball] = world_t_tolerance(q, jprim[on_ball], o[on_ball],
                                     d[on_ball])
    assert_t_close(t.numpy()[jhit], jt[jhit], tol[jhit])
    assert on_ball.mean() > 0.05 and (jhit & ~on_ball).mean() > 0.05
    occ = np.asarray(JT.scene_intersect_p(jb.geom, jray))
    np.testing.assert_array_equal(PT.scene_intersect_p(g, ray).numpy(), occ)
    assert 0.05 < occ[N // 2:].mean() < 0.95


def test_build_interaction_quadric_lanes_match_jax():
    """Quadric lanes of all three types (and triangle lanes beside them)
    against the JAX package's build_interaction, misses included."""
    q = quadric_table()
    tris = dict(PT.dummy_tris(), tv_p=np.array(
        [[-9, -5, -9], [9, -5, -9], [0, -5, 9]], np.float32),
        t_idx=np.array([[0, 1, 2]], np.int32),
        t_material=np.array([2], np.int32),
        t_alpha_tex=np.full(1, -1, np.int32))
    jg = JT.make_geometry(quadrics={k: v.copy() for k, v in q.items()},
                          tris={k: v.copy() for k, v in tris.items()})
    g = convert.geometry_from_jax(jg, device="cpu")
    assert g.has_quadrics and g.n_quadrics == 16
    ray = quadric_rays(q, N, seed=5)
    ray.d[: N // 8] = torch.tensor([0.0, -1.0, 0.0]) + 0.1 * ray.d[: N // 8]
    jray = make_ray(jnp.asarray(ray.o.numpy()), jnp.asarray(ray.d.numpy()))
    hit, t, prim, _ = JT._closest_prim(jg, jray)
    ref = JT.build_interaction(jg, jray, hit, t, prim)
    out = PT.build_interaction(g, ray, torch.tensor(np.asarray(hit)),
                               torch.tensor(np.asarray(t)),
                               torch.tensor(np.asarray(prim)))
    h, pr = np.asarray(hit), np.asarray(prim)
    types = q["q_type"][np.clip(pr, 0, 15)][h & (pr < 16)]
    assert set(types.tolist()) == {PQ.SPHERE, PQ.CYLINDER, PQ.DISK}
    assert (h & (pr >= 16)).any() and not h.all()
    for f in ("valid", "material", "arealight", "prim_id"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("t", "p", "p_error", "wo", "n", "uv", "dpdu", "dpdv", "ns", "ss",
              "ts", "dndu", "dndv"):
        close(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), msg=f)


@pytest.mark.parametrize("aa", ["closedform", "none"])
@pytest.mark.parametrize("diff", ["zero", "small", "wide"])
def test_checkerboard_matches_jax(aa, diff):
    rs = np.random.RandomState(len(aa) * 3 + len(diff))
    n = 2048
    uv = rs.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    scale = {"zero": 0.0, "small": 0.01, "wide": 0.4}[diff]
    dd = (rs.normal(size=(4, n)) * scale).astype(np.float32)
    const = {"c0": np.array([0.2, 0.3, 0.4], np.float32),
             "c1": np.array([0.9, 0.75, 0.1], np.float32)}
    mapping = (16.0, 12.0, 0.25, -0.5)
    jtex = JaxChecker(JaxConst("c0"), JaxConst("c1"), JaxUV(*mapping), aa=aa)
    ptex = CheckerboardTexture(ConstantTexture("c0"), ConstantTexture("c1"),
                               UVMapping2D(*mapping), aa=aa)
    from types import SimpleNamespace
    jsi = SimpleNamespace(uv=jnp.asarray(uv), t=jnp.zeros(n),
                          **{k: jnp.asarray(v) for k, v in zip(
                              ("dudx", "dvdx", "dudy", "dvdy"), dd)})
    psi = SimpleNamespace(uv=torch.tensor(uv), t=torch.zeros(n),
                          **{k: torch.tensor(v) for k, v in zip(
                              ("dudx", "dvdx", "dudy", "dvdy"), dd)})
    ref = np.asarray(jtex.evaluate(jsi, SimpleNamespace(textures={
        "const": {k: jnp.asarray(v) for k, v in const.items()}})))
    out = ptex.evaluate(psi, {"const": {k: torch.tensor(v)
                                        for k, v in const.items()}})
    assert out.shape == (n, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    pure = (ref == const["c0"]).all(-1) | (ref == const["c1"]).all(-1)
    if aa == "none" or diff == "zero":
        assert pure.all() and (ref == const["c0"]).all(-1).any()
    else:    # the box filter blends the checks its footprint spans
        assert (~pure).any() and (pure.any() == (diff == "small"))


def test_testball_bundle_tables_equal(testball):
    jb, pb, g = testball
    assert_bundles_equal(jb, pb)
    assert pb.geom.has_quadrics and pb.geom.n_quadrics == 1
    for k in PT.QUADRIC_KEYS:
        a, b = getattr(g, k).numpy(), getattr(pb.geom, k).numpy()
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a,
                                      b.view(np.int32) if b.dtype ==
                                      np.float32 else b, err_msg=k)
    kd = [m.kd for m in pb.material_set.materials
          if isinstance(m.kd, CheckerboardTexture)]
    assert len(kd) == 1 and kd[0].aa == "closedform"
    kd = kd[0]
    assert (kd.mapping.su, kd.mapping.sv) == (16.0, 16.0)
    # the light's two triangles come after the sphere's id
    assert pb.lights.l_prim.tolist() == [1, 2]


def test_capture_quadric_step_and_work(testball):
    """tools/quadric_work.py on a small testball render: a step's first
    K14 and K2 calls are recorded with the step's own tensors, and the
    work counts follow from them by hand (the closest search tests every
    quadric on every lane, the any-hit search stops at a lane's first
    hit; K2 counts its quadric and triangle hit lanes)."""
    from rustracer_tpu_torch.tools import quadric_work as QW
    _, pb, _ = testball
    r = pb.renderer(max_lanes=1024)
    cap = QW.capture_quadric_step(r, pb.context(), r.tiles[2])
    geom, o, d, t_max = cap["intersect_quadrics_all"]
    assert geom is pb.geom and o.shape == (1024, 3) and t_max.shape == (1024,)
    w = QW.k14_work(geom, o, d, t_max, any_hit=False)
    # one full sphere: a lane's roots add their range tests where the
    # discriminant is non-negative, and nothing more
    oc, dc = PT.quadric_object_ray(geom, 0, o, d)
    a = sum(x * x for x in dc)
    b = 2.0 * sum(x * y for x, y in zip(oc, dc))
    c = sum(x * x for x in oc) - geom.q_params[0, 0] ** 2
    n_has = int(quadratic(a, b, c)[2].sum())
    per_lane = QW.TRANSFORM_OPS + QW.SPHERE_BASE_OPS + QW.BEST_OPS \
        + 2 * QW.ROOT_HAS_OPS
    assert 0 < n_has < 1024 and w["tests"] == 1024
    assert w["ops"] == 1024 * per_lane + n_has * 2 * QW.ROOT_RANGE_OPS
    assert w["moved"] == 1024 * (28 + 9) + QW.TABLE_WORDS * 4
    geom, o, d, t_max = cap["quadrics_any_hit"]
    wa = QW.k14_work(geom, o, d, t_max, any_hit=True)
    assert wa["tests"] == o.shape[0]      # one quadric: every lane tests it
    geom, ray, hit, t, prim = cap["build_interaction"]
    ms, by, n_q, n_t = QW.k2_bound(geom, hit, prim)
    assert n_q == int((hit & (prim < 1)).sum()) > 0
    assert n_t == int((hit & (prim >= 1)).sum()) > 0
    assert n_q + n_t == int(hit.sum()) and ms > 0 and by in ("bytes",
                                                           "operations")


# object-space rays, identity transforms, t_max INF: (origin, direction)
# and the operations each lane's test does, counted by hand
K14_HAND_RAYS = {
    "sphere": ((0.7, -0.5, 0.5, 2 * np.pi), [
        ((0, 0, -5), (0, 0, 1), "roots 4.3 and 5.7, z fails at both"),
        ((-5, 0, 0), (1, 0, 0), "roots 4.3 and 5.7, both pass z"),
        ((-5, 5, 0), (1, 0, 0), "no real root"),
        ((0, 0, 0), (1, 0, 0), "from inside: t0 < 0, t1 passes z")]),
    "cylinder": ((1.0, -0.5, 0.5, 2 * np.pi), [
        ((-5, 0, 0), (1, 0, 0), "roots 4 and 6, both pass z"),
        ((0, 0, -5), (0, 0, 1), "along the axis: a == 0, no root"),
        ((-5, 0, 3), (1, 0, 0), "roots 4 and 6 above z_max")]),
    "disk": ((0.0, 1.0, 0.5, 2 * np.pi), [
        ((0, 0, -5), (0, 0, 1), "t 5 inside the inner radius"),
        ((0.7, 0, -5), (0, 0, 1), "t 5 on the ring"),
        ((0, 0, -5), (1, 0, 0), "parallel"),
        ((0, 0, -5), (0, 0, -1), "t -5 behind")]),
}


def _k14_by_hand(kind):
    """-> the operations of each of K14_HAND_RAYS[kind]'s lanes."""
    from rustracer_tpu_torch.tools import quadric_work as QW
    base = QW.TRANSFORM_OPS + QW.BEST_OPS
    quad = base + 2 * QW.ROOT_HAS_OPS
    rng, phi = QW.ROOT_RANGE_OPS, QW.PHI_OPS
    if kind == "sphere":
        quad += QW.SPHERE_BASE_OPS
        root = rng + QW.SPHERE_ROOT_OPS
        return [quad + 2 * root, quad + 2 * (root + phi), quad,
                quad + 2 * rng + QW.SPHERE_ROOT_OPS + phi]
    if kind == "cylinder":
        quad += QW.CYLINDER_BASE_OPS
        root = rng + QW.CYLINDER_ROOT_OPS
        return [quad + 2 * (root + phi), quad, quad + 2 * root]
    disk = base + QW.DISK_BASE_OPS
    return [disk + QW.DISK_ROOT_OPS, disk + QW.DISK_ROOT_OPS + phi, disk,
            disk]


def _hand_geometry(q_type, params, copies=1):
    eye = np.eye(4, dtype=np.float32)
    return PT.make_geometry(quadrics=dict(
        q_type=np.full(copies, q_type, np.int32),
        q_o2w=np.stack([eye] * copies), q_w2o=np.stack([eye] * copies),
        q_params=np.array([params] * copies, np.float32),
        q_material=np.zeros(copies, np.int32),
        q_arealight=np.full(copies, -1, np.int32),
        q_reverse=np.zeros(copies, bool)), device="cpu")


@pytest.mark.parametrize("kind", sorted(K14_HAND_RAYS))
def test_k14_work_by_hand(kind):
    """tools/quadric_work.py k14_work on one quadric of each type and
    rays whose roots fall in and out of range and pass and fail the clip
    tests: a root's point and clip tests are charged only in range, phi
    only past the z (or radius) test, a full search of one quadric."""
    from rustracer_tpu_torch.tools import quadric_work as QW
    params, rays = K14_HAND_RAYS[kind]
    q_type = {"sphere": PQ.SPHERE, "cylinder": PQ.CYLINDER,
              "disk": PQ.DISK}[kind]
    geom = _hand_geometry(q_type, params)
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    t_max = torch.full((len(rays),), float("inf"))
    per_lane = _k14_by_hand(kind)
    w = QW.k14_work(geom, o, d, t_max, any_hit=False)
    assert w["tests"] == len(rays) and w["ops"] == sum(per_lane)
    wa = QW.k14_work(geom, o, d, t_max, any_hit=True)
    assert wa["ops"] == sum(per_lane) - len(rays) * QW.BEST_OPS


def test_k14_work_follows_the_best_hit():
    """Two equal spheres: the closest search tests the second on every
    lane with the first's hit as t_max (its roots then out of range, as
    t < t_best is strict), the any-hit search only on the first's
    misses."""
    from rustracer_tpu_torch.tools import quadric_work as QW
    params, rays = K14_HAND_RAYS["sphere"]
    geom = _hand_geometry(PQ.SPHERE, params, copies=2)
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    t_max = torch.full((len(rays),), float("inf"))
    first = _k14_by_hand("sphere")
    base = QW.TRANSFORM_OPS + QW.BEST_OPS + QW.SPHERE_BASE_OPS \
        + 2 * QW.ROOT_HAS_OPS
    rng = QW.ROOT_RANGE_OPS
    # lane 0 missed the first (z fails): the second sees it all again;
    # lanes 1 and 3 hit at t 4.3 and 0.7: no root of the second below them;
    # lane 2 has no real root
    second = [first[0], base + 2 * rng, base, base + 2 * rng]
    w = QW.k14_work(geom, o, d, t_max, any_hit=False)
    assert w["tests"] == 8 and w["ops"] == sum(first) + sum(second)
    wa = QW.k14_work(geom, o, d, t_max, any_hit=True)
    no_best = [x - QW.BEST_OPS for x in first]
    assert wa["tests"] == 6
    assert wa["ops"] == sum(no_best) + no_best[0] + no_best[2]
