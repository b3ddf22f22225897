"""The geometry slice on the CPU against the JAX package's renders:
tools/geometry_work.py's ``alpha-cards`` (instanced cards with alpha and
shadow-alpha cut-outs, a medium-interface sphere, the middle split) from
one scene text at 32^2, 2 spp, and the instanced gallery of
tools/gen_instanced_gallery.py at subdivision 3 on a 2 x 2 grid at
32 x 24, 2 spp, each within tests/test_golden.py's measure (mean relative
error below 2e-3, 99th percentile below 2e-2).

Per lane, the closest hits of the camera rays through each pixel centre
(hit, prim and instance) are compared with the JAX package's and the
fraction that agrees is printed: the port drops a cut-out triangle inside
the walk, the JAX package re-traces from just past it, skipping a surface
within rej_t * 1e-4 + 1e-5 behind it and giving up after 64 rejections,
and it takes the cut-out's uv from a re-intersection in world space; at
least 99.9% agree. A file of its own, so that xdist spreads the JAX
compiles (about a minute a scene here)."""
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rustracer_tpu.core.ray import Ray as JRay
from rustracer_tpu.render.renderer import RenderConfig as JConfig
from rustracer_tpu.render.renderer import Renderer as JRenderer
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu.scene import tables as JT
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.scene.tables import closest_prim
from rustracer_tpu_torch.scenes import build_instanced
from rustracer_tpu_torch.tools.geometry_work import scene_text

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _errors(img, ref, label):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 1e-3
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    print(f"{label}: mean relative error {mean_err:.3g}, p99 {p99:.3g}")
    assert mean_err < 2e-3 and p99 < 2e-2, (mean_err, p99)


def _hits_agree(geom, jgeom, camera, res, label):
    """The camera rays through the pixel centres: the port's closest
    (hit, prim, instance) against the JAX package's, lane by lane ->
    the fraction that agrees (printed)."""
    ys, xs = np.mgrid[0:res[1], 0:res[0]].astype(np.float32) + 0.5
    p_film = torch.tensor(np.stack([xs.ravel(), ys.ravel()], -1))
    ray = camera.generate_ray_differential(p_film)
    hit, _, prim, inst = closest_prim(geom, ray, with_inst=True)
    jray = JRay(o=jnp.asarray(ray.o.numpy()), d=jnp.asarray(ray.d.numpy()),
                t_max=jnp.asarray(ray.t_max.numpy()))
    if jgeom.has_alpha:
        jh, _, jp, ji, _ = JT._closest_with_alpha(
            jgeom, jray, cols=(jgeom.t_alpha_tex,))
    else:
        jh, _, jp, ji = JT._closest_prim(jgeom, jray)
    jh, jp, ji = (np.asarray(x) for x in (jh, jp, ji))
    h, p, i = hit.numpy(), prim.numpy(), inst.numpy()
    agree = (h == jh) & ((p == jp) & (i == ji) | ~h)
    frac = float(agree.mean())
    print(f"{label}: closest hit, prim and instance agree on {frac:.5f} of "
          f"{agree.size} camera rays ({int((~agree).sum())} differ; "
          f"{int(h.sum())} hits, {int((i[h] >= 0).sum())} instanced)")
    assert (i[h] >= 0).any()
    assert frac >= 0.999
    return frac


def test_alpha_cards_match_jax(tmp_path):
    text = scene_text("alpha-cards", res=32, spp=2, tex_dir=str(tmp_path))
    jb = jax_parse_string(text).scene
    pb = parse_scene_string(text, device="cpu").scene
    g = pb.geom
    assert g.has_instances and g.has_alpha and g.has_interfaces
    assert pb.integrator.max_depth == 7 and pb.sampler.spp == 2
    _hits_agree(g, jb.geom, pb.camera, (32, 32), "alpha-cards")
    _errors(pb.render().numpy(), np.asarray(jb.render()), "alpha-cards")


def _jax_gallery(**kw):
    """tools/gen_instanced_gallery.py's build (its compilation-cache
    settings left out)."""
    path = os.path.join(REPO, "tools", "gen_instanced_gallery.py")
    spec = importlib.util.spec_from_file_location("gen_instanced_gallery",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax.config, "update"):
        spec.loader.exec_module(mod)
    return mod.build(**kw)


def test_gallery_matches_jax():
    """scenes.build_instanced: the tables of the JAX tool's build bit for
    bit, and its render."""
    kw = dict(subdiv=3, res=(32, 24), spp=2, grid=2)
    jctx, jcam, jfilm, jsampler, jinteg = _jax_gallery(**kw)
    ctx, cam, film, sampler, integ = build_instanced(device="cpu", **kw)
    for k in ("bvh16_table", "bvh16_roots", "inst_o2w", "inst_w2o",
              "inst_flip", "t_shade", "t_idx", "tv_p"):
        a, b = getattr(ctx.geom, k).numpy(), np.asarray(getattr(jctx.geom, k))
        assert a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8)), k
    _hits_agree(ctx.geom, jctx.geom, cam, kw["res"], "gallery")
    ref = np.asarray(jfilm.to_image(JRenderer(
        jinteg.li, jcam, jfilm, jsampler,
        JConfig(max_lanes=1024, collect_stats=False)).render_state(jctx)))
    img = film.to_image(Renderer(integ.li, cam, film, sampler,
                                 RenderConfig(max_lanes=1024),
                                 device="cpu").render_state(ctx)).numpy()
    _errors(img, ref, "gallery")
