"""Port parity: scene tables (make_geometry, the wide BVH build, the light
precompute) against the JAX package, plus the small matte-dragon scene that
the other tests of the port share.

Tolerance: bit-equal (the tables are host-built integer and float32 copies
of the same source data with the same arithmetic)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.accel.wide import build_wide_arrays as jax_build_wide
from rustracer_tpu.scene.tables import make_geometry as jax_make_geometry
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.scene.tables import make_geometry
from rustracer_tpu_torch.scenes import (dragon_camera, dragon_light_rows,
                                        dragon_materials, dragon_tris)

torch.set_num_threads(1)

SMALL_SUB = 4   # bumpy_sphere(4): 5,120 mesh triangles


def jax_dragon_matte(sub=SMALL_SUB, res=(32, 32), spp=1):
    """The JAX package's matte dragon (bench.py build_dragon geometry with
    the constant-matte materials of its dragon_matte config), built from
    the same host arrays as the port's, without the BVH cache or the PLY
    round trip. -> (ctx, camera, film, sampler, integrator)."""
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.render.camera import PerspectiveCamera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.lights import make_lights
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture

    tris, n_mesh = dragon_tris(sub)
    geom = jax_make_geometry(tris=tris, bvh=jax_build_wide(tris))
    rows = [dict(r, pos=(0, 0, 0)) for r in dragon_light_rows(n_mesh)]
    lights = make_lights(rows, world_center=(0, 0.5, 0), world_radius=20.0,
                         geom=geom)
    _, const = dragon_materials()
    ms = MaterialSet()
    for key in ("kd_floor", "kd_dragon", "kd_black"):
        ms.add(MatteMaterial(kd=ConstantTexture(key)))
    ctx = RenderContext(geom=geom, lights=lights, textures={
        "const": {k: jnp.asarray(v) for k, v in const.items()},
        "images": []})
    cam = dragon_camera(res)
    jcam = PerspectiveCamera(camera_to_world=cam.camera_to_world,
                             raster_to_camera=cam.raster_to_camera)
    film = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
    return (ctx, jcam, film, SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=5, compact_interior=False))


def port_ctx_from_jax(jctx):
    """The port's RenderContext over the JAX scene's own tables."""
    from rustracer_tpu_torch.render.renderer import RenderContext
    return RenderContext(
        geom=convert.geometry_from_jax(jctx.geom, device="cpu"),
        lights=convert.lights_from_jax(jctx.lights, device="cpu"),
        textures=convert.textures_from_jax(jctx.textures, device="cpu"))


@pytest.mark.parametrize("sub", [1, SMALL_SUB])
def test_make_geometry_bit_equal(sub):
    tris, _ = dragon_tris(sub)
    before = copy.deepcopy(tris)
    g = make_geometry(tris, device="cpu")
    # the port reads the caller's dict and never adds or changes keys
    assert tris.keys() == before.keys()
    for k in tris:
        np.testing.assert_array_equal(tris[k], before[k])
    jg = jax_make_geometry(tris=copy.deepcopy(tris),
                           bvh=jax_build_wide(copy.deepcopy(tris)))
    np.testing.assert_array_equal(g.t_shade.numpy().view(np.int32),
                                  np.asarray(jg.t_shade).view(np.int32))
    np.testing.assert_array_equal(g.bvh16_table.numpy().view(np.int32),
                                  np.asarray(jg.bvh16_table).view(np.int32))
    np.testing.assert_array_equal(g.bvh16_roots.numpy(),
                                  np.asarray(jg.bvh16_roots))
    assert g.bvh16_depth == np.asarray(jg.bvh16_depth_pad).shape[0]
    assert g.n_quadrics == jg.n_quadrics


def test_convert_matches_port_build():
    """Tables converted from the JAX scene equal the port's own build."""
    jctx = jax_dragon_matte(sub=2)[0]
    g = convert.geometry_from_jax(jctx.geom, device="cpu")
    lt = convert.lights_from_jax(jctx.lights, device="cpu")
    tris, n_mesh = dragon_tris(2)
    g2 = make_geometry(tris, device="cpu")
    from rustracer_tpu_torch.scene.lights import make_lights
    lt2 = make_lights(dragon_light_rows(n_mesh), g2, device="cpu")
    for a, b in ((g.t_shade, g2.t_shade), (g.bvh16_table, g2.bvh16_table),
                 (g.bvh16_roots, g2.bvh16_roots), (lt.l_area, lt2.l_area),
                 (lt.l_tri_p, lt2.l_tri_p), (lt.l_emit, lt2.l_emit),
                 (lt.l_prim, lt2.l_prim)):
        # compare bits: t_shade carries int32 ids bitcast to float (NaNs)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_real_quadric_tables_equal():
    """make_geometry's quadric tables equal the JAX package's for the same
    dict (the seeded 16-quadric table beside the small dragon's
    triangles), and the caller's dict is left as it was."""
    from rustracer_tpu_torch.scene.tables import QUADRIC_KEYS
    from rustracer_tpu_torch.tools.quadric_work import quadric_table
    tris, _ = dragon_tris(1)
    q = quadric_table()
    before = copy.deepcopy(q)
    g = make_geometry(tris, quadrics=q, device="cpu")
    for k in q:
        np.testing.assert_array_equal(q[k], before[k])
    jg = jax_make_geometry(quadrics=copy.deepcopy(q), tris=copy.deepcopy(tris),
                           bvh=jax_build_wide(copy.deepcopy(tris)))
    assert g.has_quadrics and g.n_quadrics == jg.n_quadrics == 16
    for k in QUADRIC_KEYS:
        a, b = getattr(g, k).numpy(), np.asarray(getattr(jg, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(g.t_shade.numpy().view(np.int32),
                                  np.asarray(jg.t_shade).view(np.int32))
    # without quadrics: the reference's never-hit dummy row
    g0 = make_geometry(tris, device="cpu")
    assert not g0.has_quadrics and g0.n_quadrics == 1
    np.testing.assert_array_equal(g0.q_params.numpy(),
                                  np.asarray(jax_make_geometry(
                                      tris=copy.deepcopy(tris)).q_params))
