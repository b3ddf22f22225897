"""Port parity: alpha cutouts (the alpha filter in the plain twin of K1's
walk, scene/bundle.py bake_alpha, the ``alpha`` and ``shadowalpha`` mesh
parameters) against the JAX package, on tests/test_alpha.py's scenes.

The probes of tests/test_alpha.py (a half-cut quad before a wall) give the
same hits, t and occlusions as the JAX package's re-tracing loop (t within
1e-5 relative: the loop adds the rejected surface's local t to the
advanced origin's); the bakes of a constant, an imagemap and a
checkerboard texture equal the JAX package's bit for bit; the parsed
scene's tables too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TriBuilder
from rustracer_tpu.core.ray import Ray as JRay
from rustracer_tpu.scene import bundle as JB
from rustracer_tpu.scene import textures as JT
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu.scene.tables import make_geometry as jax_make_geometry
from rustracer_tpu.scene.tables import scene_intersect as jax_intersect
from rustracer_tpu.scene.tables import scene_intersect_p as jax_intersect_p
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.ray import Ray
from rustracer_tpu_torch.render.imageio import write_image
from rustracer_tpu_torch.scene import textures as T
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.scene.bundle import bake_alpha
from rustracer_tpu_torch.scene.materials import MaterialSet
from rustracer_tpu_torch.scene.tables import scene_intersect, scene_intersect_p

torch.set_num_threads(1)


def _alpha_scene(with_bvh, shadow_all_zero=False):
    """tests/test_alpha.py's scene: a quad at z=0 whose left half is cut
    out, before a solid wall at z=1 -> (JAX tables, the port's)."""
    tb = TriBuilder()
    tb.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), material=0)
    tb.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), material=0)
    tris = tb.build()
    tris["t_alpha_tex"] = np.array([0, 0, -1, -1], np.int32)
    if shadow_all_zero:
        tris["t_shadow_alpha_tex"] = np.array([1, 1, -1, -1], np.int32)
    m0 = np.zeros((4, 4), np.float32)
    m0[:, 2:] = 1.0
    alpha = dict(alpha_atlas=np.concatenate([m0.ravel(),
                                             np.zeros(16, np.float32)]),
                 alpha_meta=np.array([[0, 4, 4], [16, 4, 4]], np.int32))
    bvh = None
    if with_bvh:
        from rustracer_tpu.accel.bvh import build_bvh_arrays
        bvh = build_bvh_arrays(None, tris)
    jg = jax_make_geometry(tris=tris, bvh=bvh, alpha=alpha)
    return jg, convert.geometry_from_jax(jg, device="cpu")


def _rays(xs, t_max=np.inf):
    n = len(xs)
    o = np.stack([np.asarray(xs, np.float32), np.full(n, 0.5, np.float32),
                  np.full(n, -1.0, np.float32)], -1)
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    t = np.full(n, t_max, np.float32)
    return (JRay(o=jnp.asarray(o), d=jnp.asarray(d), t_max=jnp.asarray(t)),
            Ray(o=torch.tensor(o), d=torch.tensor(d), t_max=torch.tensor(t)))


def _closest(jg, g, xs):
    jr, pr = _rays(xs)
    sj, sp = jax_intersect(jg, jr), scene_intersect(g, pr)
    np.testing.assert_array_equal(sp.valid.numpy(), np.asarray(sj.valid))
    np.testing.assert_array_equal(sp.prim_id.numpy(), np.asarray(sj.prim_id))
    np.testing.assert_allclose(sp.t.numpy(), np.asarray(sj.t), rtol=1e-5)
    return sp.t.numpy()


def _occluded(jg, g, xs, t_max):
    jr, pr = _rays(xs, t_max)
    occ = scene_intersect_p(g, pr).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jax_intersect_p(jg, jr)))
    return occ


@pytest.mark.parametrize("with_bvh", [False, True])
class TestAlphaMask:
    def test_camera_rays_pass_through_cutout(self, with_bvh):
        jg, g = _alpha_scene(with_bvh)
        assert g.has_alpha
        t = _closest(jg, g, [0.25, 0.75])
        assert t[0] == pytest.approx(2.0, rel=1e-3)
        assert t[1] == pytest.approx(1.0, rel=1e-3)

    def test_shadow_rays_honor_alpha(self, with_bvh):
        jg, g = _alpha_scene(with_bvh)
        occ = _occluded(jg, g, [0.25, 0.75], 1.5)
        assert not occ[0] and occ[1]

    def test_shadowalpha_overrides_shadow_rays(self, with_bvh):
        jg, g = _alpha_scene(with_bvh, shadow_all_zero=True)
        assert not _occluded(jg, g, [0.25, 0.75], 1.5).any()
        assert _closest(jg, g, [0.75])[0] == pytest.approx(1.0, rel=1e-3)

    def test_no_alpha_unaffected(self, with_bvh):
        tb = TriBuilder()
        tb.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
        tb.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
        jg = jax_make_geometry(tris=tb.build())
        g = convert.geometry_from_jax(jg, device="cpu")
        assert not g.has_alpha
        np.testing.assert_allclose(_closest(jg, g, [0.25, 0.75]), 1.0,
                                   rtol=1e-3)


_PARSED = """
Film "image" "integer xresolution" [32] "integer yresolution" [16]
Camera "perspective" "float fov" [50]
Sampler "02sequence" "integer pixelsamples" [4]
Integrator "path"
WorldBegin
  LightSource "point" "rgb I" [40 40 40] "point from" [0 3 0]
  Texture "mask" "float" "imagemap" "string filename" "{png}"
  AttributeBegin
    Material "matte" "rgb Kd" [0.8 0.8 0.8]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-2 1.5 -2   2 1.5 -2   2 1.5 2   -2 1.5 2]
      "float uv" [0 0  1 0  1 1  0 1]
      "texture alpha" "mask"
  AttributeEnd
  Material "matte" "rgb Kd" [0.8 0.8 0.8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 0 -4   4 0 -4   4 0 4   -4 0 4]
    "float shadowalpha" [0]
WorldEnd
"""


def test_alpha_through_parser(tmp_path):
    """tests/test_alpha.py's parsed scene (its integrator the path
    integrator: the port refuses the direct-lighting one, and the probe
    reads only the tables), a literal "float shadowalpha" [0] added on the
    floor: the same alpha tables and atlas as the JAX package, and shadow
    probes from the floor blocked only under the opaque half."""
    mask = np.zeros((4, 4, 3), np.float32)
    mask[:, 2:, :] = 1.0
    png = str(tmp_path / "mask.png")
    write_image(png, mask)
    text = _PARSED.format(png=png)
    g = parse_scene_string(text, device="cpu").scene.geom
    jb = jax_parse_string(text).scene
    assert g.has_alpha
    for k in ("alpha_atlas", "alpha_meta", "t_alpha_tex",
              "t_shadow_alpha_tex"):
        a, b = getattr(g, k).numpy(), np.asarray(getattr(jb.geom, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert g.t_shadow_alpha_tex.tolist()[2:] == [1, 1]
    o = np.array([[-1.0, 0.01, 0.0], [1.0, 0.01, 0.0]], np.float32)
    d = np.tile(np.array([0, 1, 0], np.float32), (2, 1))
    occ = scene_intersect_p(g, Ray(o=torch.tensor(o), d=torch.tensor(d),
                                   t_max=torch.full((2,), 10.0))).numpy()
    jocc = np.asarray(jax_intersect_p(jb.geom, JRay(
        o=jnp.asarray(o), d=jnp.asarray(d), t_max=jnp.full(2, 10.0))))
    np.testing.assert_array_equal(occ, jocc)
    assert not occ[0] and occ[1]


def _bake_pair(kind, tmp_path):
    """(JAX texture, JAX textures, port texture, port textures, lookups)
    of one float texture: a constant 0, an imagemap, a checkerboard of two
    float constants."""
    from rustracer_tpu.ops.mipmap import build_pyramid as jax_pyramid
    from rustracer_tpu_torch.ops.mipmap import build_pyramid
    from rustracer_tpu_torch.scene.atlas import build_atlas_meta
    from rustracer_tpu_torch.scenes import textures_on
    const = {"a": np.float32(0.0), "b": np.float32(1.0)}
    images = []
    if kind == "constant":
        jt, pt = JT.ConstantTexture("a", False), T.ConstantTexture("a", False)
    elif kind == "imagemap":
        rs = np.random.RandomState(3)
        img = (rs.rand(12, 20, 3) > 0.5).astype(np.float32) \
            * rs.rand(12, 20, 3).astype(np.float32)
        images = [img]
        jt = JT.ImageTexture(0, is_spectrum=False)
        pt = T.ImageTexture(0, is_spectrum=False)
    else:
        jt = JT.CheckerboardTexture(JT.ConstantTexture("a", False),
                                    JT.ConstantTexture("b", False),
                                    JT.UVMapping2D(4.0, 4.0))
        pt = T.CheckerboardTexture(T.ConstantTexture("a", False),
                                   T.ConstantTexture("b", False),
                                   T.UVMapping2D(4.0, 4.0),
                                   is_spectrum=False)
    jtex = {"const": {k: jnp.asarray(v) for k, v in const.items()},
            "images": [[jnp.asarray(lv) for lv in jax_pyramid(i)]
                       for i in images]}
    ptex = {"const": const, "images": [build_pyramid(i) for i in images]}
    if images:
        ptex.update(build_atlas_meta(ptex["images"]))
    ptex = textures_on(ptex, "cpu")
    return jt, jtex, pt, ptex, MaterialSet([]).lookups(ptex, "cpu")


@pytest.mark.parametrize("kind", ["constant", "imagemap", "checkerboard"])
def test_bake_alpha_matches_jax(kind, tmp_path):
    """scene/bundle.py bake_alpha against the JAX package's _bake_alpha:
    the same grid, bit for bit (a constant's 2 x 2, an image at its
    level-0 size (the pyramid's, a power of two), another texture at
    64 x 64)."""
    jt, jtex, pt, ptex, lookups = _bake_pair(kind, tmp_path)
    ref = JB._bake_alpha(jt, jtex)
    out = bake_alpha(pt, ptex, lookups, torch.device("cpu"))
    assert out.shape == ref.shape == {"constant": (2, 2), "imagemap": (16, 32),
                                      "checkerboard": (64, 64)}[kind]
    np.testing.assert_array_equal(out, ref)
    if kind != "constant":
        assert (out == 0).any() and (out > 0).any()
