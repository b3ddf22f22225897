"""Port parity of the Cornell box (``rustracer_tpu_torch.scenes``
build_cornell, a jax-free copy of tests/helpers.py cornell_box,
cornell_camera and cornell_imagemap_materials) against ``bench.py``
build_cornell's JAX scene: the host tables and textures bit-equal, and the
path integrator lane by lane at 32^2, with constant walls and with the red
and green walls as atlas imagemaps.

Tolerance: per-lane radiance within 1e-4 relative (1e-5 absolute) on at
least 99% of the lanes, as tests/test_torch_path.py (the port walks its
wide BVH, the JAX bench scene its triangles brute force: a hit tie on a
shared edge may go to either triangle)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from helpers import cornell_camera as jax_cornell_camera
from helpers import cornell_imagemap_materials
from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu.render.sampler import DimAllocator as JaxDims
from rustracer_tpu_torch.render.renderer import Lanes
from rustracer_tpu_torch.render.sampler import DimAllocator
from rustracer_tpu_torch.scenes import (build_cornell, cornell_camera,
                                        cornell_materials, cornell_tris)

torch.set_num_threads(1)

RES = (32, 32)


def test_tables_and_textures_match_helpers():
    jctx = bench.build_cornell()[0]
    tris, first = cornell_tris()
    np.testing.assert_array_equal(np.asarray(jctx.geom.tv_p), tris["tv_p"])
    np.testing.assert_array_equal(np.asarray(jctx.geom.t_idx),
                                  tris["t_idx"])
    np.testing.assert_array_equal(np.asarray(jctx.lights.l_emit)[:, :3],
                                  np.full((2, 3), 15.0, np.float32))
    assert first == 10
    jcam, cam = jax_cornell_camera(RES), cornell_camera(RES)
    np.testing.assert_array_equal(np.asarray(jcam.raster_to_camera),
                                  cam.raster_to_camera)
    _, jtex = cornell_imagemap_materials(seed_base=10)
    _, tex = cornell_materials(imagemap_walls=(1, 2))
    for k in jtex["const"]:
        np.testing.assert_array_equal(np.asarray(jtex["const"][k]),
                                      tex["const"][k])
    for jp, p in zip(jtex["images"], tex["images"], strict=True):
        for a, b in zip(jp, p, strict=True):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                          b.view(np.int32))
    for k in ("atlas_meta", "atlas_levels"):
        np.testing.assert_array_equal(np.asarray(jtex[k]), tex[k])


@pytest.mark.parametrize("walls", [(), (1, 2)], ids=["const", "imagemaps"])
def test_path_radiance_per_lane(walls):
    jctx, _, _, jsampler, jinteg = bench.build_cornell()
    if walls:
        ms, textures = cornell_imagemap_materials(seed_base=10)
        jctx = jctx._replace(textures=textures)
        jinteg = dataclasses.replace(jinteg, mat_set=ms)
    jcam = jax_cornell_camera(RES)
    ctx, cam, _, sampler, integ = build_cornell(res=RES, imagemap_walls=walls,
                                                device="cpu")
    assert (sampler.spp, integ.max_depth) == (jsampler.spp, jinteg.max_depth)
    ys, xs = np.mgrid[0:RES[1], 0:RES[0]]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    pix = (py.astype(np.int64) * RES[0] + px).astype(np.uint32)
    xy = np.stack([px, py], -1).astype(np.float32)
    scale = 1.0 / np.sqrt(jsampler.spp)

    @jax.jit
    def jax_li(pixel_idx, pixel_xy):
        lanes = JaxLanes(pixel_idx=pixel_idx,
                         sample_idx=jnp.full_like(pixel_idx, 3))
        p_film, p_lens, _ = jsampler.get_camera_sample(
            pixel_xy, lanes.pixel_idx, lanes.sample_idx)
        ray = jcam.generate_ray_differential(p_film, p_lens)
        return jinteg._run(jctx, ray.scaled_differentials(scale), lanes,
                           jsampler, JaxDims())[0]

    ref = np.asarray(jax_li(jnp.asarray(pix), jnp.asarray(xy)))
    lanes = Lanes(pixel_idx=torch.as_tensor(pix.astype(np.int64)),
                  sample_idx=torch.full((len(pix),), 3, dtype=torch.int64))
    p_film, _, _ = sampler.get_camera_sample(torch.as_tensor(xy),
                                             lanes.pixel_idx,
                                             lanes.sample_idx)
    ray = cam.generate_ray_differential(p_film).scaled_differentials(scale)
    out = integ._run(ctx, ray, lanes, sampler, DimAllocator()).numpy()
    close = np.all(np.abs(out - ref) <= 1e-5 + 1e-4 * np.abs(ref), axis=-1)
    print(f"diverging lanes: {int((~close).sum())} of {len(close)}")
    assert close.mean() >= 0.99
    assert (ref.sum(-1) > 0).mean() > 0.9        # the box is lit
