"""Port parity of the slice end to end: the path integrator on the small
matte dragon against the JAX package's ``PathIntegrator._run`` lane by lane,
and the port's Renderer image against the JAX Renderer's.

Tolerance: per-lane radiance within 1e-4 relative (1e-5 absolute) on at
least 99% of the lanes (a Russian-roulette branch or a hit tie can flip a
lane, and float differences in the warps move a few bounce rays across
triangle edges; the count of diverging lanes is printed); image mean within
1e-3 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu.render.renderer import RenderConfig as JaxRenderConfig
from rustracer_tpu.render.renderer import Renderer as JaxRenderer
from rustracer_tpu.render.sampler import DimAllocator as JaxDims
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.integrators.path import PathIntegrator
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.filters import Filter
from rustracer_tpu_torch.render.renderer import (Lanes, RenderConfig,
                                                 Renderer)
from rustracer_tpu_torch.render.sampler import DimAllocator
from rustracer_tpu_torch.scenes import dragon_materials

from test_torch_geometry import jax_dragon_matte, port_ctx_from_jax

torch.set_num_threads(1)

RES = (32, 32)


def _port(jctx, jcam, jsampler):
    ms, _ = dragon_materials()
    return (port_ctx_from_jax(jctx), convert.camera_from_jax(jcam),
            convert.sampler_from_jax(jsampler),
            PathIntegrator(mat_set=ms, max_depth=5))


def test_path_radiance_per_lane():
    jctx, jcam, _, jsampler, jinteg = jax_dragon_matte(res=RES, spp=1)
    ctx, cam, sampler, integ = _port(jctx, jcam, jsampler)
    ys, xs = np.mgrid[0:RES[1], 0:RES[0]]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    pix = (py.astype(np.int64) * RES[0] + px).astype(np.uint32)
    xy = np.stack([px, py], -1).astype(np.float32)

    @jax.jit
    def jax_li(pixel_idx, pixel_xy):
        lanes = JaxLanes(pixel_idx=pixel_idx,
                         sample_idx=jnp.zeros_like(pixel_idx))
        p_film, p_lens, _ = jsampler.get_camera_sample(
            pixel_xy, lanes.pixel_idx, lanes.sample_idx)
        ray = jcam.generate_ray_differential(p_film, p_lens)
        return jinteg._run(jctx, ray, lanes, jsampler, JaxDims())[0]

    ref = np.asarray(jax_li(jnp.asarray(pix), jnp.asarray(xy)))
    lanes = Lanes(pixel_idx=torch.as_tensor(pix.astype(np.int64)),
                  sample_idx=torch.zeros(len(pix), dtype=torch.int64))
    p_film, _, _ = sampler.get_camera_sample(torch.as_tensor(xy),
                                             lanes.pixel_idx,
                                             lanes.sample_idx)
    ray = cam.generate_ray_differential(p_film)
    out = integ._run(ctx, ray, lanes, sampler, DimAllocator()).numpy()
    close = np.all(np.abs(out - ref) <= 1e-5 + 1e-4 * np.abs(ref), axis=-1)
    print(f"diverging lanes: {int((~close).sum())} of {len(close)}")
    assert close.mean() >= 0.99
    assert (ref.sum(-1) > 0).mean() > 0.3        # the scene is lit


def test_renderer_image_mean():
    jctx, jcam, jfilm, jsampler, jinteg = jax_dragon_matte(res=RES, spp=2)
    ctx, cam, sampler, integ = _port(jctx, jcam, jsampler)
    ref = np.asarray(JaxRenderer(
        jinteg.li, jcam, jfilm, jsampler,
        JaxRenderConfig(max_lanes=1 << 10, collect_stats=False)).render(jctx))
    film = Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5))
    img = Renderer(integ.li, cam, film, sampler,
                   RenderConfig(max_lanes=1 << 10),
                   device="cpu").render(ctx).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert ref.mean() > 1e-2
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()
