"""Port parity of the scene api and bundle (``rustracer_tpu_torch.scene.api``,
``scene.bundle``) against the JAX package's ``parse_scene``, on the CPU.

For ``scenes/cornell-box.pbrt`` and a scene string that uses what the port
renders (transforms, named coordinate systems, TransformBegin/End,
ReverseOrientation, named materials, a PLY mesh, constant and imagemap
textures as float and spectrum over a PNG, a two-sided area light, a crop
window, film scale, a Gaussian filter, a thin lens and a screen window),
the JAX bundle's tables go through ``convert.py`` and are compared with the
port's (``assert_bundles_equal``, which tests/test_torch_quadrics.py also
holds the testball-matte scene to): geometry with the quadric tables, BVH bytes, light tables, camera matrices, film, sampler
and integrator settings bit-equal, the texture constants bit-equal, the
texel pyramids within 1e-6. The spatial grid's tables are compared in
tests/test_torch_lightdistrib.py. Every directive the port refuses raises
NotImplementedError naming itself and its ROADMAP.md item; what it refused
until the rest of shading was ported (bump maps, a mix over a material
with an imagemap, the procedural textures, the planar mapping, trilinear
filtering, the Fourier material) builds the same materials and textures as
the JAX package; what it refused until the rest of the geometry was
ported (instances, an unknown instance, alpha cut-outs, a medium
interface) builds the JAX package's tables, and so do a kdtree and the
middle split; each light
directive it refused until the lights were ported (point, distant,
infinite, an area light on a sphere or a disk) builds the JAX package's
light table, and renders under the direct and Whitted integrators as the
JAX package's integrators do, lane by lane, like each integrator refused
until section A, item 16 ported them; transforms and LookAt come out bit-equal; the
camera of a LookAt scene equals ``scenes.py``'s ``Transform.look_at``.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rustracer_tpu.scene.api import parse_scene as jax_parse
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.ops import bsdf as PB
from rustracer_tpu_torch.scene import textures as PT
from rustracer_tpu_torch.scene.api import parse_scene, parse_scene_string
from rustracer_tpu_torch.scene.tables import QUADRIC_KEYS
from rustracer_tpu_torch.utils.plyio import write_ply

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def assert_bundles_equal(jb, pb):
    g = convert.geometry_from_jax(jb.geom, device="cpu")
    for f in ("tv_p", "t_idx", "t_reverse", "t_shade", "bvh16_table",
              "bvh16_roots") + QUADRIC_KEYS:
        _eq(getattr(g, f).numpy(), getattr(pb.geom, f).numpy())
    assert g.bvh16_depth == pb.geom.bvh16_depth
    assert g.has_quadrics == pb.geom.has_quadrics
    lt = convert.lights_from_jax(jb.lights, device="cpu")
    for f in ("l_type", "l_emit", "l_prim", "l_twosided", "l_area",
              "l_tri_p", "l_tri_rev", "world_center"):
        _eq(getattr(lt, f).numpy(), getattr(pb.lights, f).numpy())
    assert lt.world_radius == pb.lights.world_radius
    _eq(jb.camera.camera_to_world, pb.camera.camera_to_world)
    _eq(jb.camera.raster_to_camera, pb.camera.raster_to_camera)
    c = convert.camera_from_jax(jb.camera)
    for f in ("lens_radius", "focal_distance", "shutter_open",
              "shutter_close"):
        assert getattr(c, f) == getattr(pb.camera, f)
    assert convert.film_from_jax(jb.film) == pb.film
    assert convert.sampler_from_jax(jb.sampler) == pb.sampler
    assert jb.filename == pb.filename
    ji, pi = jb.integrator, pb.integrator
    assert (ji.max_depth, ji.rr_threshold) == (pi.max_depth, pi.rr_threshold)
    assert (jb.light_grid is None) == (pb.light_grid is None)
    # textures: constants bit-equal, pyramids within 1e-6, atlas metadata
    assert sorted(jb.textures["const"]) == sorted(pb.textures["const"])
    for k, v in jb.textures["const"].items():
        _eq(v, pb.textures["const"][k].numpy())
    assert len(jb.textures["images"]) == len(pb.textures["images"])
    for jp, pp in zip(jb.textures["images"], pb.textures["images"]):
        assert len(jp) == len(pp)
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6,
                                       rtol=0)
    for k in ("atlas_meta", "atlas_levels"):
        assert (k in jb.textures) == (k in pb.textures)
        if k in jb.textures:
            _eq(jb.textures[k], pb.textures[k].numpy())
    # materials: the same kd textures, mattes whose sigma is the constant 0
    ms = convert.material_set_from_jax(jb.material_set, jb.textures)
    assert len(ms.materials) == len(pb.material_set.materials)
    for a, b in zip(ms.materials, pb.material_set.materials):
        assert type(a.kd) is type(b.kd)
        if isinstance(a.kd, PT.ConstantTexture):
            assert a.kd.key == b.kd.key
        elif isinstance(a.kd, PT.CheckerboardTexture):
            assert (a.kd.tex1.key, a.kd.tex2.key, a.kd.aa) == \
                (b.kd.tex1.key, b.kd.tex2.key, b.kd.aa)
            assert vars(a.kd.mapping) == vars(b.kd.mapping)
        else:
            assert vars(a.kd).keys() == vars(b.kd).keys()
            for k in ("image_id", "trilinear", "max_aniso", "wrap", "scale",
                      "is_spectrum"):
                assert getattr(a.kd, k) == getattr(b.kd, k)
            assert vars(a.kd.mapping) == vars(b.kd.mapping)


def test_cornell_box_tables_equal():
    path = os.path.join(REPO, "scenes", "cornell-box.pbrt")
    jb, pb = jax_parse(path).scene, parse_scene(path, device="cpu").scene
    assert_bundles_equal(jb, pb)
    assert pb.light_grid is not None and pb.geom.n_triangles == 32


SCENE = '''
LookAt 0.5 1.5 -2.5  0.2 0.3 0.4  0 1 0
Camera "perspective" "float fov" [38] "float lensradius" [0.05]
  "float focaldistance" [2.8] "float screenwindow" [-1 1 -0.8 0.8]
Sampler "02sequence" "integer pixelsamples" [4]
Film "image" "integer xresolution" [40] "integer yresolution" [32]
  "float cropwindow" [0.1 0.9 0.0 0.75] "float scale" [1.5]
  "string filename" "mesh.exr"
PixelFilter "gaussian" "float xwidth" [1.5] "float ywidth" [1.5]
  "float alpha" [2.5]
Integrator "path" "integer maxdepth" [4] "float rrthreshold" [0.5]
  "string lightsamplestrategy" "uniform"
WorldBegin
Texture "grid" "spectrum" "imagemap" "string filename" "tex.png"
  "float uscale" [2] "float vscale" [3] "string wrap" "clamp"
Texture "gridf" "float" "imagemap" "string filename" "tex.png"
  "bool gamma" "false"
Texture "white" "spectrum" "constant" "rgb value" [0.7 0.7 0.7]
Texture "zero" "float" "constant" "float value" [0]
MakeNamedMaterial "floor" "string type" "matte" "texture Kd" "grid"
MakeNamedMaterial "wall" "string type" "matte" "texture Kd" "white"
  "texture sigma" "zero"
AttributeBegin
  Translate 0 2 0
  Rotate 30 1 0.5 0.2
  AreaLightSource "diffuse" "rgb L" [6 5 4] "bool twosided" "true"
  Material "matte" "rgb Kd" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-0.3 0 -0.3  0.3 0 -0.3  0.3 0 0.3  -0.3 0 0.3]
AttributeEnd
CoordinateSystem "base"
TransformBegin
  Scale 2 1 2
  NamedMaterial "floor"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
    "float uv" [0 0 1 0 1 1 0 1]
TransformEnd
ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0.2 0.1 0.9 1]
ReverseOrientation
NamedMaterial "wall"
Shape "plymesh" "string filename" "mesh.ply"
CoordSysTransform "base"
Scale -1 1 1
Material "matte" "rgb Kd" [0.2 0.5 0.3]
Shape "trianglemesh" "integer indices" [0 1 2 2 1 3]
  "point P" [0 0 1.5  0.5 0 1.5  0 0.5 1.5  0.5 0.5 1.7]
  "normal N" [0 0 -1  0 0 -1  0 0 -1  0.1 0 -1]
WorldEnd
'''


def _mesh_scene(tmp_path):
    rng = np.random.RandomState(11)
    px = rng.randint(0, 256, (12, 20, 3)).astype(np.uint8)
    Image.fromarray(px).save(str(tmp_path / "tex.png"))
    p = (rng.rand(30, 3) * 0.6).astype(np.float32)
    idx = rng.randint(0, 30, (24, 3)).astype(np.int32)
    n = rng.randn(30, 3).astype(np.float32)
    uv = rng.rand(30, 2).astype(np.float32)
    write_ply(str(tmp_path / "mesh.ply"), p, idx, n=n, uv=uv)
    return SCENE


def test_mesh_scene_string_tables_equal(tmp_path, monkeypatch):
    text = _mesh_scene(tmp_path)
    monkeypatch.chdir(tmp_path)
    jb = jax_parse_string(text).scene
    pb = parse_scene_string(text, device="cpu").scene
    assert_bundles_equal(jb, pb)
    assert pb.camera.lens_radius > 0 and pb.film.filter.kind == "gaussian"
    assert pb.film.scale == 1.5 and pb.filename == "rt-mesh.exr"
    # PBRT's [x0 x1 y0 y1] as (x0, y0, x1, y1), float32 values
    assert pb.film.crop_window == tuple(float(np.float32(v))
                                        for v in (0.1, 0.0, 0.9, 0.75))
    assert len(pb.textures["images"]) == 2 and pb.light_grid is None


def test_spatial_strategy_builds_the_grid(tmp_path, monkeypatch):
    text = _mesh_scene(tmp_path).replace(
        '"string lightsamplestrategy" "uniform"', "")
    monkeypatch.chdir(tmp_path)
    pb = parse_scene_string(text, device="cpu").scene
    assert pb.light_grid is not None and pb.lights.n_lights == 2


_HEAD = '''Camera "perspective"
Film "image" "integer xresolution" [8] "integer yresolution" [8]
{options}
WorldBegin
{world}
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1 1 0 1 0 1 1]
WorldEnd
'''
# what the port refused until the other integrators were ported (ROADMAP
# A16): every light under the direct and Whitted integrators
# (estimate_direct, with the lights' pdf_li and infinite_le_one), and each
# integrator; and the random sampler, refused until the run surface was
# ported (A17), under the path integrator (depth 3) with a point light;
# each of these renders now, as the JAX package renders it
REFUSED = {
    "sphere": ('Integrator "directlighting"',
               'AreaLightSource "diffuse"\nShape "sphere"',
               "'directlighting'", 16),
    "disk": ('Integrator "whitted"', 'AreaLightSource "diffuse" "rgb L" '
             '[2 2 2]\nShape "disk" "float radius" [0.5]', "'whitted'", 16),
    "point light": ('Integrator "directlighting"', 'LightSource "point"',
                    "'directlighting'", 16),
    "distant light": ('Integrator "whitted"', 'LightSource "distant"',
                      "'whitted'", 16),
    "infinite light": ('Integrator "directlighting"',
                       'LightSource "infinite"', "'directlighting'", 16),
    "whitted": ('Integrator "whitted"', '', "'whitted'", 16),
    "directlighting": ('Integrator "directlighting"', '',
                       "'directlighting'", 16),
    "ao": ('Integrator "ao"', '', "'ao'", 16),
    "normal": ('Integrator "normal"', '', "'normal'", 16),
    "random sampler": ('Sampler "random"\nIntegrator "path" "integer '
                       'maxdepth" [3]', 'LightSource "point"', "'path'", 17),
}


# what the port refused until the rest of shading was ported: each parses on
# both packages into the same textures and materials
_BUMP = 'Texture "b" "float" "constant" "float value" [1]\n'
_GRID = os.path.join(REPO, "scenes", "textures", "grid.png")
SHADING = {
    "plastic": _BUMP + 'Material "plastic" "texture bumpmap" "b"',
    "glass": _BUMP + 'Material "glass" "texture bumpmap" "b"',
    "substrate": _BUMP + 'Material "substrate" "texture bumpmap" "b"',
    "translucent": _BUMP + 'Material "translucent" "texture bumpmap" "b"',
    "oren-nayar": _BUMP + 'Material "matte" "float sigma" [20] '
    '"texture bumpmap" "b"',
    "bumpmap": _BUMP + 'Material "matte" "texture bumpmap" "b"',
    "mix": (f'Texture "g" "spectrum" "imagemap" "string filename" "{_GRID}"\n'
            'MakeNamedMaterial "a" "string type" "matte" "texture Kd" "g"\n'
            'MakeNamedMaterial "b" "string type" "disney"\n'
            'Material "mix" "string namedmaterial1" "a" '
            '"string namedmaterial2" "b"'),
    "marble": 'Translate 1 2 3\nTexture "m" "spectrum" "marble" '
    '"float scale" [2]\nMaterial "matte" "texture Kd" "m"',
    "fbm": 'Rotate 30 0 1 0\nTexture "f" "float" "fbm" "integer octaves" '
    '[4]\nMaterial "metal" "texture roughness" "f"',
    "scale texture": 'Texture "w" "float" "wrinkled"\nTexture "s" "spectrum" '
    '"scale" "texture tex1" "w" "rgb tex2" [0.5 0.2 0.1]\n'
    'Material "matte" "texture Kd" "s"',
    "planar mapping": (f'Texture "p" "spectrum" "imagemap" "string filename" '
                       f'"{_GRID}" "string mapping" "planar" "vector v1" '
                       '[0 0 2] "vector v2" [1 1 0] "float udelta" [0.5]\n'
                       'Material "matte" "texture Kd" "p"'),
    "trilinear": (f'Texture "t" "spectrum" "imagemap" "string filename" '
                  f'"{_GRID}" "bool trilinear" "true" "string wrap" "black"'
                  '\nMaterial "matte" "texture Kd" "t"'),
    "fourier": 'Material "fourier" "string bsdffile" "{bsdf}"',
}


def assert_same_objects(p, j, path="m"):
    """The port's material or texture ``p`` and the JAX one ``j`` carried
    over by convert.py: the same classes, and every attribute of the JAX
    one equal in the port's (floats and arrays bit for bit)."""
    assert type(p).__name__ == type(j).__name__, path
    for k, jv in vars(j).items():
        pv = getattr(p, k)
        if isinstance(jv, (bool, int, float, str)) or jv is None:
            assert pv == jv, (path, k, pv, jv)
        elif isinstance(jv, np.ndarray):
            _eq(pv, jv)
        else:
            assert_same_objects(pv, jv, f"{path}.{k}")


@pytest.mark.parametrize("case", sorted(SHADING))
def test_shading_directive_builds_the_references(case, tmp_path):
    """Bump maps on plastic, glass, substrate, translucent, Oren-Nayar and
    Lambertian mattes, a mix over a material with an imagemap, the marble,
    fbm and scale textures (the 3D mapping of the transform where each is
    declared), the planar mapping, a trilinear imagemap and the Fourier
    material build the same materials and textures in both packages, and
    the same texture tables (a Fourier table set included)."""
    from rustracer_tpu_torch.tools.texture_work import write_fourier_table
    world = SHADING[case].format(bsdf=write_fourier_table(
        str(tmp_path / "t.bsdf")))
    text = _HEAD.format(options="", world=world)
    jb = jax_parse_string(text).scene
    pb = parse_scene_string(text, device="cpu").scene
    ref = convert.material_set_from_jax(jb.integrator.mat_set, jb.textures)
    assert len(pb.material_set.materials) == len(ref.materials)
    for i, (pm, jm) in enumerate(zip(pb.material_set.materials,
                                     ref.materials)):
        assert_same_objects(pm, jm, f"material {i}")
    assert sorted(pb.textures["const"]) == sorted(jb.textures["const"])
    for k, v in jb.textures["const"].items():
        _eq(pb.textures["const"][k].numpy(), np.asarray(v))
    assert len(pb.textures.get("images", [])) == \
        len(jb.textures.get("images", []))
    if case == "fourier":
        ts = convert.fourier_from_jax(jb.textures["fourier"], "cpu")
        for a, b in zip(pb.textures["fourier"], ts):
            _eq(np.asarray(a), np.asarray(b))
        assert pb.material_set.types_present() == (PB.FOURIER,)


# what the port refused until the rest of the geometry was ported
# (ROADMAP.md section A, item 15): each parses on both packages into the
# same tables
_CARD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
         '[0 0 2  1 0 2  1 1 2  0 1 2] "float uv" [0 0 1 0 1 1 0 1]')
GEOMETRY = {
    "instancing": (f'ObjectBegin "o"\n{_CARD}\nObjectEnd\n'
                   'TransformBegin\nTranslate 1 0 0\nObjectInstance "o"\n'
                   'TransformEnd\nTransformBegin\nRotate 30 0 1 0\n'
                   'Scale -1 1 1\nObjectInstance "o"\nTransformEnd'),
    "instance": 'ObjectInstance "o"',
    "alpha": (f'{_CARD} "float alpha" [0]\nTexture "g" "float" "imagemap" '
              f'"string filename" "{_GRID}"\n'
              f'{_CARD} "texture shadowalpha" "g"'),
    "medium interface": 'Material "none"',
}


@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_geometry_directive_builds_the_references(case):
    """Instances of an object (one mirrored), an ObjectInstance of an
    unknown name, alpha and shadow-alpha cut-outs (a literal 0 and an
    imagemap) and a Material "none" shape build the JAX package's tables:
    the bundles equal, and the instance tables, the alpha atlas and ids
    and the medium-interface flag carried by convert.py equal the port's
    own."""
    text = _HEAD.format(options="", world=GEOMETRY[case])
    jb = jax_parse_string(text).scene
    pb = parse_scene_string(text, device="cpu").scene
    assert_bundles_equal(jb, pb)
    g, cg = pb.geom, convert.geometry_from_jax(jb.geom, device="cpu")
    for f in ("inst_o2w", "inst_w2o", "inst_flip", "alpha_atlas",
              "alpha_meta", "t_alpha_tex", "t_shadow_alpha_tex"):
        _eq(getattr(cg, f).numpy(), getattr(g, f).numpy())
    for f in ("has_instances", "has_alpha", "has_interfaces"):
        assert getattr(cg, f) == getattr(g, f), f
    assert (g.has_instances, g.has_alpha, g.has_interfaces) == {
        "instancing": (True, False, False), "instance": (False,) * 3,
        "alpha": (False, True, False),
        "medium interface": (False, False, True)}[case]


def _li_both(pb, jb):
    """The radiance of sample 0's camera rays (the renderer's first tile)
    from the port's integrator and from the JAX package's, run op by op
    (jax.disable_jit) on the same rays and lanes."""
    import jax
    import jax.numpy as jnp
    from rustracer_tpu.core.ray import Ray as JaxRay
    from rustracer_tpu.render.renderer import Lanes as JaxLanes
    from rustracer_tpu.render.sampler import DimAllocator as JaxDims
    from rustracer_tpu_torch.render.renderer import Lanes
    from rustracer_tpu_torch.render.sampler import DimAllocator
    px, py, _ = pb.renderer(1 << 16).tiles[0]
    pix = py.long() * pb.film.full_resolution[0] + px.long()
    smp = torch.zeros_like(pix)
    p_film, p_lens, _ = pb.sampler.get_camera_sample(
        torch.stack([px, py], -1).float(), pix, smp)
    ray = pb.camera.generate_ray_differential(p_film, p_lens)
    ray = ray.scaled_differentials(1.0 / np.sqrt(pb.sampler.spp))
    li = pb.integrator.li(pb.context(), ray, Lanes(pix, smp), pb.sampler,
                          DimAllocator()).numpy()
    jray = JaxRay(*[jnp.asarray(getattr(ray, f).numpy()) for f in (
        "o", "d", "t_max", "rx_origin", "rx_direction", "ry_origin",
        "ry_direction")])
    jl = JaxLanes(jnp.asarray(pix.numpy().astype(np.uint32)),
                  jnp.asarray(smp.numpy().astype(np.uint32)))
    with jax.disable_jit():
        ref = np.asarray(jb.integrator.li(jb.context(), jray, jl, jb.sampler,
                                          JaxDims()))
    return li, ref


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_directive_raises_naming_itself(case):
    """Each case renders (8^2, the sampler's spp: 16, or the random
    sampler's 4, finite) under the integrator it names, and sample 0's
    radiance on every lane equals the JAX package's
    integrator run op by op on the same camera rays within 1e-5 (absolute
    and relative). Op by op, not the JAX package's compiled render: in the
    sphere case the camera sits inside the sphere light, and where a hit's
    |p|^2 rounds above r^2 the reference samples the light's cone from the
    light's own surface; XLA's compiled arithmetic rounds |p|^2 otherwise
    than its own ops and the port do, and so takes other lanes there."""
    options, world, what, item = REFUSED[case]
    text = _HEAD.format(options=options, world=world)
    pb = parse_scene_string(text, device="cpu").scene
    assert pb.integrator_name == what.strip("'")
    if item == 17:
        assert (pb.sampler.kind, pb.sampler.spp) == ("random", 4)
    img = pb.render().numpy()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    li, ref = _li_both(pb, jax_parse_string(text).scene)
    print(f"{case}: sample 0 radiance mean {ref.mean():.4g}, max abs error "
          f"{np.abs(li - ref).max():.3g}")
    np.testing.assert_allclose(li, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accel", ['Accelerator "kdtree"',
                                   'Accelerator "bvh" "string splitmethod" '
                                   '"middle"'])
def test_unbuilt_accelerator_raises(accel):
    """The accelerators the port refused until the middle split was ported
    now build: over 40 triangles (more than the 8 primitives below which
    the JAX package builds no BVH), the port's wide BVH is the JAX
    package's bit for bit (a kdtree's the SAH one: neither package reads
    the accelerator's name)."""
    rs = np.random.RandomState(4)
    p = rs.uniform(-1, 1, (40, 3)).repeat(3, 0) + rs.normal(0, 0.2, (120, 3))
    world = ('Shape "trianglemesh" "integer indices" ['
             + " ".join(map(str, range(120))) + '] "point P" ['
             + " ".join(f"{v:.5f}" for v in p.ravel()) + "]")
    text = _HEAD.format(options=accel, world=world)
    g = parse_scene_string(text, device="cpu").scene.geom
    jg = jax_parse_string(text).scene.geom
    _eq(g.bvh16_table.numpy(), np.asarray(jg.bvh16_table))
    assert g.bvh16_depth == np.asarray(jg.bvh16_depth_pad).shape[0]


def test_mix_missing_a_named_material_is_matte():
    """A mix naming a material the scene does not define takes a matte,
    as the reference's does; the named one it finds stays in the set."""
    text = _HEAD.format(options="", world=(
        'MakeNamedMaterial "a" "string type" "plastic"\n'
        'Material "mix" "string namedmaterial1" "a" '
        '"string namedmaterial2" "nowhere"'))
    jms = jax_parse_string(text).scene.integrator.mat_set
    pms = parse_scene_string(text, device="cpu").scene.material_set
    names = [type(m).__name__ for m in pms.materials]
    assert names == [type(m).__name__ for m in jms.materials]
    assert names[-2:] == ["PlasticMaterial", "MatteMaterial"]


def test_reference_unimplemented_shape_keeps_its_error():
    text = _HEAD.format(options="", world='Shape "cone"')
    with pytest.raises(NotImplementedError) as j:
        jax_parse_string(text)
    with pytest.raises(NotImplementedError) as p:
        parse_scene_string(text, device="cpu")
    assert str(j.value) == str(p.value)


# the light directives the port refused until it ported them (ROADMAP.md
# section A, item 14): each now builds the JAX package's light table
LIGHTS = {
    "sphere": 'AreaLightSource "diffuse"\nShape "sphere"',
    "disk": 'AreaLightSource "diffuse" "rgb L" [2 2 2]\n'
            'Shape "disk" "float radius" [0.5]',
    "point light": 'LightSource "point"',
    "distant light": 'LightSource "distant"',
    "infinite light": 'LightSource "infinite"',
}


@pytest.mark.parametrize("case", sorted(LIGHTS))
def test_light_directive_builds_the_reference_table(case):
    """One light directive over _HEAD's triangle (an area light applies to
    it too): the port's light rows, their order, types, positions and
    emissions are the JAX package's; an infinite light without a map
    carries the 4 x 8 map of ones."""
    text = _HEAD.format(options='Integrator "path" '
                        '"string lightsamplestrategy" "uniform"',
                        world=LIGHTS[case])
    jb = jax_parse_string(text).scene
    plt = parse_scene_string(text, device="cpu").scene.lights
    clt = convert.lights_from_jax(jb.lights, geom=jb.geom, device="cpu")
    assert plt.kinds == clt.kinds and plt.inf_rows == clt.inf_rows
    for f in ("l_type", "l_prim", "l_twosided", "l_q_type", "l_cone"):
        assert torch.equal(getattr(plt, f), getattr(clt, f)), f
    for f in ("l_pos", "l_emit", "l_area"):
        np.testing.assert_allclose(getattr(plt, f).numpy(),
                                   getattr(clt, f).numpy(), rtol=1e-6)
    for m in plt.inf_maps:
        assert m.shape == (4, 8, 3) and bool((m == 1).all())


DIRECTIVES = [
    ("translate", (0.5, -2.0, 3.25)), ("scale", (2.0, 0.5, -1.5)),
    ("rotate", (33.0, 0.2, 1.0, -0.4)), ("rotate", (90.0, 0.0, 0.0, 1.0)),
    ("look_at", ((278, 273, -800), (278, 273, 0), (0, 1, 0))),
    ("concat_transform", ([2, 0.1, 0, 0, 0.3, 1, 0.2, 0, 0, 0.5, 1.5, 0,
                           1, 2, 3, 1],)),
    ("look_at", ((0.0, 1.1, -3.4), (0.0, 0.0, 0.0), (0, 1, 0))),
]


def test_transforms_bit_equal():
    from rustracer_tpu.scene.api import RealApi as JaxApi
    from rustracer_tpu_torch.scene.api import RealApi
    ja, pa = JaxApi(), RealApi(device="cpu")
    ja.init()
    pa.init()
    for name, args in DIRECTIVES:
        getattr(ja, name)(*args)
        getattr(pa, name)(*args)
        _eq(ja.cur_transform.m, pa.cur_transform.m)
        _eq(ja.cur_transform.m_inv, pa.cur_transform.m_inv)
        assert ja.cur_transform.swaps_handedness() == \
            pa.cur_transform.swaps_handedness()


def test_lookat_camera_is_the_dragons():
    """LookAt as the only transform: the camera-to-world matrix equals
    ``Transform.look_at`` (in value: the identity product turns its -0.0
    entries into 0.0)."""
    from rustracer_tpu_torch.scenes import dragon_camera
    text = '''LookAt 0 1.1 -3.4  0 0 0  0 1 0
Camera "perspective" "float fov" [42]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1 1 0 1 0 1 1]
WorldEnd'''
    cam = parse_scene_string(text, device="cpu").scene.camera
    ref = dragon_camera((16, 16))
    np.testing.assert_array_equal(cam.camera_to_world, ref.camera_to_world)
    _eq(cam.raster_to_camera, ref.raster_to_camera)


def test_parse_defaults_to_cuda():
    import inspect
    for fn in (parse_scene, parse_scene_string):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        parse_scene(os.path.join(REPO, "scenes", "cornell-box.pbrt"))


@pytest.mark.parametrize("strategy", ["uniform", "spatial"])
def test_dragon_scene_file_is_build_dragon(tmp_path, strategy):
    """tools/dragon_scene.py's file, parsed: with the uniform strategy the
    vertex, index and wide-BVH tables are build_dragon's bit for bit and a
    1-sample 24^2 render (sub 2) matches build_dragon's within the
    golden-image tolerance; with the spatial grid the render is finite."""
    from rustracer_tpu_torch.scenes import build_dragon
    from rustracer_tpu_torch.tools.dragon_scene import write_dragon_scene
    res = (24, 24)
    path = write_dragon_scene(str(tmp_path), sub=2, res=res,
                              strategy=strategy)
    pb = parse_scene(path, device="cpu").scene
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=2, res=res,
                                                     device="cpu")
    img = pb.render(max_lanes=1024, sample_stop=1).numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-4
    assert (pb.light_grid is None) == (strategy == "uniform")
    if strategy == "spatial":
        return
    for f in ("tv_p", "t_idx", "bvh16_table", "bvh16_roots"):
        _eq(getattr(pb.geom, f).numpy(), getattr(ctx.geom, f).numpy())
    _eq(pb.camera.raster_to_camera, cam.raster_to_camera)
    assert pb.sampler == sampler and pb.integrator.max_depth == 5
    for a, b in zip(pb.textures["images"][0], ctx.textures["images"][0]):
        _eq(a.numpy(), b.numpy())
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    ref = film.to_image(Renderer(integ.li, cam, film, sampler,
                                 RenderConfig(max_lanes=1024), device="cpu")
                        .render_state(ctx, sample_stop=1)).numpy()
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    assert err.mean() / scale < 2e-3 and \
        np.percentile(err, 99) / scale < 2e-2
