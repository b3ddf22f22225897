"""Port parity: instancing (accel/bvh_build.py build_wide_scene, the plain
twin of K1's instanced walk, K2's instance branch, the directives) against
the JAX package, on tests/test_instancing.py's seeded scenes.

Tolerances: the two-level tables (record table, roots, depth, instance
tables) and the middle split's bit for bit; hit, prim and instance equal
on every lane, t within K1's tolerance (tests/test_torch_traverse16.py:
1e-5 relative or 1e-6 absolute), the observed counts equal; the
interaction's fields within 2e-4 (the JAX package's own test of the
instanced interaction against replicated geometry: the vertices are moved
to world space under jit, whose contractions round apart from the eager
form). Renders of parsed scenes within tests/test_golden.py's measure."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.accel.traverse16 import bvh16_intersect_counts
from rustracer_tpu.accel.wide import build_wide_arrays as jax_build_wide
from rustracer_tpu.accel.wide import build_wide_scene as jax_build_scene
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu.scene.tables import scene_intersect as jax_intersect
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.accel import bvh_build
from rustracer_tpu_torch.accel.traverse16 import traverse16
from rustracer_tpu_torch.core.ray import Ray
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.scene.tables import make_geometry, scene_intersect

from test_bvh import random_rays, random_soup
from test_instancing import _QUAD_MESH, _instanced_setup, _mk_tris

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6


def _rays(rays):
    return tuple(torch.tensor(np.asarray(x)) for x in (rays.o, rays.d,
                                                       rays.t_max))


def _tables_equal(a, b):
    for k in ("bvh16_table", "bvh16_roots", "inst_o2w", "inst_w2o",
              "inst_flip"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k
    assert int(a["bvh16_depth"]) == int(b["bvh16_depth"])


def _port_build(n_obj_tris=60, n_static=25, n_inst=7, seed=3,
                allow_flip=False, split="sah"):
    """tests/test_instancing.py _instanced_setup's tables, built by both
    packages -> (JAX's build_wide_scene, the port's)."""
    from test_instancing import _rot_scale_trans
    rng = np.random.default_rng(seed)
    static = random_soup(n_static, seed=seed + 1)
    obj = random_soup(n_obj_tris, seed=seed + 2)
    obj_p = np.asarray(obj["tv_p"]) * 0.3
    xforms = [_rot_scale_trans(rng, allow_flip) for _ in range(n_inst)]
    sv, si = np.asarray(static["tv_p"]), np.asarray(static["t_idx"])
    gv = np.concatenate([sv, obj_p])
    gi = np.concatenate([si, np.asarray(obj["t_idx"]) + len(sv)])
    tris = _mk_tris(gv, gi)
    objects = [(len(si), len(gi))]
    inst = [dict(obj=0, o2w=m, w2o=np.linalg.inv(m),
                 flip=bool(np.linalg.det(m[:3, :3]) < 0)) for m in xforms]
    return (jax_build_scene(tris, objects, inst, split),
            bvh_build.build_wide_scene(tris, objects, inst, split))


@pytest.mark.parametrize("split", ["sah", "middle"])
@pytest.mark.parametrize("case", [dict(), dict(allow_flip=True, seed=9),
                                  dict(n_static=0, n_inst=5, seed=40),
                                  dict(n_inst=1, seed=30)],
                         ids=["static", "flip", "no-static", "one"])
def test_build_wide_scene_bit_equal(case, split):
    """build_wide_scene: the record table, roots, depth and the instance
    tables (a single instance padded with an identity row) bit for bit."""
    j, p = _port_build(split=split, **case)
    _tables_equal(j, p)
    assert p["inst_o2w"].shape[0] >= 2


def test_gallery_tables_bit_equal():
    """The instanced gallery at subdivision 3: scenes.instanced_tris's
    tables, fed to both packages' builders, give the same BVH, and the
    port's build_instanced holds them."""
    from rustracer_tpu_torch.scenes import build_instanced, instanced_tris
    tris, objects, inst = instanced_tris(subdiv=3, grid=5)
    j = jax_build_scene(tris, objects, inst)
    p = bvh_build.build_wide_scene(tris, objects, inst)
    _tables_equal(j, p)
    ctx = build_instanced(subdiv=3, res=(8, 6), spp=1, device="cpu")[0]
    assert ctx.geom.has_instances and ctx.geom.inst_o2w.shape[0] == 25
    np.testing.assert_array_equal(ctx.geom.bvh16_table.numpy().view(np.int32),
                                  np.asarray(j["bvh16_table"]).view(np.int32))


@pytest.mark.parametrize("n", [40, 700])
def test_middle_split_bit_equal(n):
    """The middle split's wide table (no instances) bit for bit."""
    tris = random_soup(n, seed=n)
    j = jax_build_wide(tris, "middle")
    p = bvh_build.build_wide_arrays(tris["tv_p"], tris["t_idx"], "middle")
    np.testing.assert_array_equal(p["bvh16_table"].view(np.int32),
                                  j["bvh16_table"].view(np.int32))
    assert p["bvh16_depth"] == int(j["bvh16_depth"])


def _walk_parity(jgeom, rays, any_hit):
    """Port's plain walk against the JAX package's on every lane."""
    geom = convert.geometry_from_jax(jgeom, device="cpu")
    assert geom.has_instances
    jh, jt, jp, ji, jc = (np.asarray(x) for x in bvh16_intersect_counts(
        jgeom, rays, any_hit=any_hit))
    h, t, p, i, c = (x.numpy() for x in traverse16(
        geom, *_rays(rays), any_hit=any_hit, with_counts=True,
        with_inst=True))
    np.testing.assert_array_equal(c, jc.astype(np.int64))
    np.testing.assert_array_equal(h, jh)
    if not any_hit:
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(t[h], jt[h], rtol=RTOL, atol=ATOL)
    return h, i


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("allow_flip", [False, True])
def test_walk_matches_jax(allow_flip, any_hit):
    """Closest and any hit against the replicated mesh's scene, with and
    without handedness-flipping instances: hit, prim, instance, t and the
    counts as the JAX package's walk."""
    geom, _, _ = _instanced_setup(allow_flip=allow_flip,
                                  seed=3 if not any_hit else 9)
    h, i = _walk_parity(geom, random_rays(2048, seed=5 if not any_hit
                                          else 10), any_hit)
    if not any_hit:
        assert (i[h] >= 0).any() and (i[h] < 0).any()


@pytest.mark.parametrize("case", [dict(n_inst=1, seed=30),
                                  dict(n_static=0, n_inst=5, seed=40)],
                         ids=["one-instance", "no-static"])
def test_walk_edge_cases_match_jax(case):
    """One instance (its table padded with an identity row) and a scene of
    instances alone."""
    geom, _, _ = _instanced_setup(**case)
    _walk_parity(geom, random_rays(1024, seed=case["seed"] + 1), False)


def test_scene_intersect_interaction_matches_jax():
    """The interaction of instanced hits (K2's instance branch, plain):
    valid, prim and material equal, points, normals and uv within 2e-4 of
    the JAX package's."""
    jgeom, _, _ = _instanced_setup(seed=12, allow_flip=True)
    rays = random_rays(1024, seed=13)
    geom = convert.geometry_from_jax(jgeom, device="cpu")
    o, d, t_max = _rays(rays)
    si = scene_intersect(geom, Ray(o=o, d=d, t_max=t_max))
    sj = jax_intersect(jgeom, rays)
    v = np.asarray(sj.valid)
    np.testing.assert_array_equal(si.valid.numpy(), v)
    np.testing.assert_array_equal(si.prim_id.numpy()[v],
                                  np.asarray(sj.prim_id)[v])
    for f in ("p", "n", "ns", "uv", "dpdu", "dpdv", "p_error"):
        np.testing.assert_allclose(getattr(si, f).numpy()[v],
                                   np.asarray(getattr(sj, f))[v],
                                   rtol=2e-4, atol=2e-4, err_msg=f)


def test_memory_is_shared():
    """1000 instances of one mesh cost the mesh once and about two records
    an instance: the table does not scale with instances x mesh."""
    def rows(n_inst):
        tris = random_soup(200, seed=22)
        rng = np.random.default_rng(20)
        inst = []
        for _ in range(n_inst):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = rng.uniform(-40, 40, 3)
            inst.append(dict(obj=0, o2w=m, w2o=np.linalg.inv(m)))
        w = bvh_build.build_wide_scene(tris, [(0, 200)], inst)
        g = make_geometry(tris, bvh=w, device="cpu")
        return g.bvh16_table.shape[0], g
    small, _ = rows(2)
    big, g = rows(1000)
    assert big - small < 3 * 998, (small, big)
    assert g.inst_o2w.shape[0] == 1000 and g.n_triangles == 200


_HEAD = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "02sequence" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [55]
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [0 3 -3]
Material "matte" "rgb Kd" [0.7 0.6 0.5]
"""
_PLACEMENTS = ["Translate -1 0 0", "Translate 1 0.3 0.5",
               "Rotate 40 0 1 0\nTranslate 0 -0.8 0", "Scale -1 1 1"]


def test_parser_instances_equal_explicit_copies():
    """N ObjectInstances render as N explicit copies (tests/
    test_instancing.py's case, a mirrored one added), with one shared
    card, and parse to the JAX package's tables."""
    inst = (_HEAD + 'ObjectBegin "card"\n' + _QUAD_MESH + 'ObjectEnd\n'
            + "".join(f'TransformBegin\n{p}\nObjectInstance "card"\n'
                      'TransformEnd\n' for p in _PLACEMENTS) + "WorldEnd\n")
    expl = (_HEAD + "".join(f'AttributeBegin\n{p}\n{_QUAD_MESH}\n'
                            'AttributeEnd\n' for p in _PLACEMENTS)
            + "WorldEnd\n")
    bi = parse_scene_string(inst, device="cpu").scene
    be = parse_scene_string(expl, device="cpu").scene
    g = bi.geom
    assert g.has_instances and g.inst_o2w.shape[0] == 4
    assert g.n_triangles == 2 and bool(g.inst_flip[3])
    jg = jax_parse_string(inst).scene.geom
    for k in ("bvh16_table", "inst_o2w", "inst_w2o", "inst_flip", "t_shade"):
        a, b = getattr(g, k).numpy(), np.asarray(getattr(jg, k))
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
    img_i, img_e = bi.render().numpy(), be.render().numpy()
    assert img_i.mean() > 1e-3
    np.testing.assert_allclose(img_i, img_e, rtol=1e-4, atol=1e-5)


def test_parser_unknown_instance_is_ignored():
    """An ObjectInstance of an unknown name is logged and ignored: the
    scene renders as without it."""
    text = _HEAD + 'ObjectInstance "nope"\n' + _QUAD_MESH + "WorldEnd\n"
    b = parse_scene_string(text, device="cpu").scene
    assert not b.geom.has_instances and b.geom.n_triangles == 2
    img = b.render().numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-3


def test_emissive_and_quadric_records_are_cloned():
    """An object's emissive mesh and its sphere are cloned per instance
    (the light table names concrete prims); its plain mesh is shared:
    both packages build the same quadric, light and instance tables."""
    text = (_HEAD + 'ObjectBegin "lamp"\nAttributeBegin\n'
            'AreaLightSource "diffuse" "rgb L" [2 2 2]\n' + _QUAD_MESH
            + 'AttributeEnd\nShape "sphere" "float radius" [0.2]\n'
            'Translate 0 0 1\n' + _QUAD_MESH + 'ObjectEnd\n'
            + "".join(f'TransformBegin\n{p}\nObjectInstance "lamp"\n'
                      'TransformEnd\n' for p in _PLACEMENTS[:3])
            + "WorldEnd\n")
    b = parse_scene_string(text, device="cpu").scene
    jb = jax_parse_string(text).scene
    assert b.geom.n_quadrics == 3 and b.geom.has_instances
    assert b.lights.n_lights == jb.lights.l_type.shape[0] == 7
    for k in ("q_o2w", "t_shade", "bvh16_table", "inst_o2w"):
        a, c = getattr(b.geom, k).numpy(), np.asarray(getattr(jb.geom, k))
        assert np.array_equal(a.view(np.uint8), c.view(np.uint8)), k
    np.testing.assert_array_equal(b.lights.l_prim.numpy(),
                                  np.asarray(jb.lights.l_prim))
    ref = np.asarray(jb.render())
    img = b.render().numpy()
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    assert err.mean() / scale < 2e-3 and np.percentile(err, 99) / scale < 2e-2
