"""Port parity of the textured headline dragon (bench.py build_dragon: the
hero mesh's imagemap through the shared atlas, a 64-spp config) on the
small mesh: the hero texture, the material conversion, ``MaterialSet.shade``
and the path integrator lane by lane against the JAX package, and the
Renderer's image mean.

Tolerances: hero pyramid and registration tables bit-equal; shade lobe
types and active flags equal, lobe parameters within 1e-5 absolute except
on atlas floor-flip lanes (at most 0.1%, tests/test_torch_atlas.py); per-
lane radiance within 1e-4 relative (1e-5 absolute) on at least 99% of the
lanes, as tests/test_torch_path.py; image mean within 1e-3 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rustracer_tpu.accel.wide import build_wide_arrays as jax_build_wide
from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu.render.renderer import RenderConfig as JaxRenderConfig
from rustracer_tpu.render.renderer import Renderer as JaxRenderer
from rustracer_tpu.render.sampler import DimAllocator as JaxDims
from rustracer_tpu.scene.tables import make_geometry as jax_make_geometry
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.interaction import Interaction
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.filters import Filter
from rustracer_tpu_torch.render.renderer import (Lanes, RenderConfig,
                                                 RenderContext, Renderer)
from rustracer_tpu_torch.render.sampler import DimAllocator
from rustracer_tpu_torch.scenes import (DRAGON_SPP, dragon_camera,
                                        dragon_light_rows,
                                        dragon_materials_textured,
                                        dragon_tris, hero_texture)

torch.set_num_threads(1)

SMALL_SUB = 4   # bumpy_sphere(4): 5,120 mesh triangles
RES = (32, 32)


def bench_hero_texture():
    """bench.py:188-193, the reference's hero texture, verbatim."""
    from rustracer_tpu.ops.mipmap import build_pyramid
    from rustracer_tpu.scene.atlas import build_atlas_meta
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 128.0
    tex = np.stack([0.45 + 0.25 * np.sin(14 * xx + 5 * np.sin(3 * yy)),
                    0.40 + 0.15 * np.sin(11 * yy + 4 * np.sin(5 * xx)),
                    0.32 + 0.10 * np.cos(9 * (xx + yy))], -1)
    images = [[jnp.asarray(lv) for lv in
               build_pyramid(tex.astype(np.float32))]]
    return images, build_atlas_meta(images)


def jax_dragon_textured(sub=SMALL_SUB, res=RES, spp=DRAGON_SPP):
    """The JAX package's textured dragon (bench.py build_dragon's materials
    and textures) on the port's host geometry, without the BVH cache or the
    PLY round trip. -> (ctx, camera, film, sampler, integrator)."""
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.render.camera import PerspectiveCamera
    from rustracer_tpu.render.film import Film as JaxFilm
    from rustracer_tpu.render.filters import Filter as JaxFilter
    from rustracer_tpu.render.renderer import RenderContext as JaxContext
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.scene.lights import make_lights
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture, ImageTexture

    tris, n_mesh = dragon_tris(sub)
    geom = jax_make_geometry(tris=tris, bvh=jax_build_wide(tris))
    rows = [dict(r, pos=(0, 0, 0)) for r in dragon_light_rows(n_mesh)]
    lights = make_lights(rows, world_center=(0, 0.5, 0), world_radius=20.0,
                         geom=geom)
    _, const = dragon_materials_textured()
    images, am = bench_hero_texture()
    ms = MaterialSet()
    ms.add(MatteMaterial(kd=ConstantTexture("kd_floor")))
    ms.add(MatteMaterial(kd=ImageTexture(0)))
    ms.add(MatteMaterial(kd=ConstantTexture("kd_black")))
    ctx = JaxContext(geom=geom, lights=lights, textures={
        "const": {k: jnp.asarray(v) for k, v in const.items()},
        "images": images, "atlas_meta": am["atlas_meta"],
        "atlas_levels": am["atlas_levels"]})
    cam = dragon_camera(res)
    jcam = PerspectiveCamera(camera_to_world=cam.camera_to_world,
                             raster_to_camera=cam.raster_to_camera)
    film = JaxFilm(full_resolution=res, filter=JaxFilter("box", 0.5, 0.5))
    return (ctx, jcam, film, SamplerConfig(kind="02sequence", spp=spp),
            PathIntegrator(mat_set=ms, max_depth=5, compact_interior=False))


def port_from_jax(jctx, jcam, jsampler, jinteg):
    """-> (ctx, camera, sampler, integrator) of the port over the JAX
    scene's own tables and materials."""
    from rustracer_tpu_torch.integrators.path import PathIntegrator
    ctx = RenderContext(
        geom=convert.geometry_from_jax(jctx.geom, device="cpu"),
        lights=convert.lights_from_jax(jctx.lights, device="cpu"),
        textures=convert.textures_from_jax(jctx.textures, device="cpu"))
    return (ctx, convert.camera_from_jax(jcam),
            convert.sampler_from_jax(jsampler),
            PathIntegrator(mat_set=convert.material_set_from_jax(
                jinteg.mat_set), max_depth=jinteg.max_depth))


def _pixels():
    ys, xs = np.mgrid[0:RES[1], 0:RES[0]]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    pix = (py.astype(np.int64) * RES[0] + px).astype(np.uint32)
    return pix, np.stack([px, py], -1).astype(np.float32)


def _jax_camera(jcam, jsampler, pixel_idx, pixel_xy):
    lanes = JaxLanes(pixel_idx=pixel_idx,
                     sample_idx=jnp.zeros_like(pixel_idx))
    p_film, p_lens, _ = jsampler.get_camera_sample(
        pixel_xy, lanes.pixel_idx, lanes.sample_idx)
    ray = jcam.generate_ray_differential(p_film, p_lens)
    return lanes, ray.scaled_differentials(1.0 / np.sqrt(jsampler.spp))


def test_hero_texture_matches_bench():
    images, meta = hero_texture()
    ref, ref_meta = bench_hero_texture()
    assert len(images[0]) == len(ref[0]) == 8
    for a, b in zip(images[0], ref[0]):
        np.testing.assert_array_equal(a.view(np.int32),
                                      np.asarray(b).view(np.int32))
    for k in ("atlas_meta", "atlas_levels"):
        np.testing.assert_array_equal(meta[k], ref_meta[k])


def test_material_set_from_jax():
    jms = jax_dragon_textured(sub=1)[4].mat_set
    ms = convert.material_set_from_jax(jms)
    n, slot, regs, _ = ms.atlas_prep()
    jn, jslot, jregs, _ = jms.atlas_prep()
    assert n == jn == 1
    np.testing.assert_array_equal(slot, jslot)
    for k in jregs:
        np.testing.assert_array_equal(regs[k], jregs[k])


def test_shade_matches_jax():
    """Lobes of the camera hits of the 32^2 frame, shaded from the same
    interaction in both packages."""
    from rustracer_tpu.core.interaction import compute_differentials
    from rustracer_tpu.scene.tables import scene_intersect
    jctx, jcam, _, jsampler, jinteg = jax_dragon_textured()
    ctx, _, _, integ = port_from_jax(jctx, jcam, jsampler, jinteg)
    pix, xy = _pixels()
    _, ray = _jax_camera(jcam, jsampler, jnp.asarray(pix), jnp.asarray(xy))
    jsi = compute_differentials(scene_intersect(jctx.geom, ray), ray)
    _, jl = jinteg.mat_set.shade(jsi, jctx)
    fields = {f.name: torch.as_tensor(np.array(getattr(jsi, f.name)))
              for f in dataclasses.fields(Interaction)}
    si = Interaction(**fields)
    si2, lobes = integ.mat_set.shade(si, ctx)
    assert si2 is si
    np.testing.assert_array_equal(lobes.type.numpy(), np.asarray(jl.type))
    np.testing.assert_array_equal(lobes.active.numpy(),
                                  np.asarray(jl.active))
    err = np.abs(lobes.params.numpy() - np.asarray(jl.params)).max((-1, -2))
    hero = np.asarray(jsi.material) == 1
    assert hero.mean() > 0.2 and (err[~hero] == 0).all()
    assert (err > 1e-5).mean() <= 1e-3
    # the texture varies over the hero mesh
    assert lobes.params[hero.nonzero()[0], 0, 0].std() > 0.01


def test_textured_radiance_per_lane():
    jctx, jcam, _, jsampler, jinteg = jax_dragon_textured()
    ctx, cam, sampler, integ = port_from_jax(jctx, jcam, jsampler, jinteg)
    pix, xy = _pixels()

    @jax.jit
    def jax_li(pixel_idx, pixel_xy):
        lanes, ray = _jax_camera(jcam, jsampler, pixel_idx, pixel_xy)
        return jinteg._run(jctx, ray, lanes, jsampler, JaxDims())[0]

    ref = np.asarray(jax_li(jnp.asarray(pix), jnp.asarray(xy)))
    lanes = Lanes(pixel_idx=torch.as_tensor(pix.astype(np.int64)),
                  sample_idx=torch.zeros(len(pix), dtype=torch.int64))
    p_film, _, _ = sampler.get_camera_sample(torch.as_tensor(xy),
                                             lanes.pixel_idx,
                                             lanes.sample_idx)
    ray = cam.generate_ray_differential(p_film).scaled_differentials(
        1.0 / np.sqrt(sampler.spp))
    out = integ._run(ctx, ray, lanes, sampler, DimAllocator()).numpy()
    close = np.all(np.abs(out - ref) <= 1e-5 + 1e-4 * np.abs(ref), axis=-1)
    print(f"diverging lanes: {int((~close).sum())} of {len(close)}")
    assert close.mean() >= 0.99
    assert (ref.sum(-1) > 0).mean() > 0.3        # the scene is lit


def test_textured_renderer_image_mean():
    """Two samples of the 64-spp config through both Renderers."""
    jctx, jcam, jfilm, jsampler, jinteg = jax_dragon_textured()
    ctx, cam, sampler, integ = port_from_jax(jctx, jcam, jsampler, jinteg)
    jr = JaxRenderer(jinteg.li, jcam, jfilm, jsampler,
                     JaxRenderConfig(max_lanes=1 << 10, collect_stats=False))
    ref = np.asarray(jfilm.to_image(jr.render_state(jctx, sample_stop=2)))
    film = Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5))
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=1 << 10),
                 device="cpu")
    img = film.to_image(r.render_state(ctx, sample_stop=2)).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert ref.mean() > 1e-2
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()
