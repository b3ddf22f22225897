"""Renders through the path chain's kernel route (ops/pathshade.py, on the
CPU its plain twins) against the general chain and against the JAX
package.

- The matte dragon, the parsed Cornell box (its spatial grid pick: K13's
  plain versions) and the gallery at 24 x 16 to 64^2, 1 spp, with the
  alive-first slab opened to their small wavefronts (the dragon and the
  gallery take a slab tier): the route's image is the general chain's,
  bit for bit, and the twins ran.
- The Cornell box at 32^2, 2 spp through the port's Renderer on the route
  against the JAX Renderer: image mean within 1e-3 relative, as
  tests/test_torch_path.py holds the dragon's.
"""
import os

import numpy as np
import pytest
import torch

import bench
from rustracer_tpu.render.film import Film as JaxFilm
from rustracer_tpu.render.filters import Filter as JaxFilter
from rustracer_tpu.render.renderer import RenderConfig as JaxRenderConfig
from rustracer_tpu.render.renderer import Renderer as JaxRenderer
from rustracer_tpu_torch.integrators import path as P
from rustracer_tpu_torch.ops import pathshade as PS
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scenes import build_cornell

from helpers import cornell_camera as jax_cornell_camera

torch.set_num_threads(1)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def _scene(name):
    """-> (ctx, camera, film, sampler, integrator) of a small scene."""
    from rustracer_tpu_torch.scene.api import parse_scene
    from rustracer_tpu_torch.scenes import build_dragon_matte, build_instanced
    if name == "matte dragon":
        return build_dragon_matte(sub=3, res=(32, 32), spp=2,
                                  device="cpu")[:5]
    if name == "gallery":
        return build_instanced(subdiv=2, res=(24, 16), spp=2, grid=3,
                               device="cpu")
    b = parse_scene(os.path.join(SCENES, "cornell-box.pbrt"),
                    device="cpu").scene
    assert b.context().light_grid is not None
    return b.context(), b.camera, b.film, b.sampler, b.integrator


def _render(scene, route, samples, lanes):
    ctx, cam, film, sampler, integ = scene
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=lanes),
                 device="cpu")
    orig = P.PathIntegrator.kernel_route
    if not route:
        P.PathIntegrator.kernel_route = lambda self, c: False
    try:
        return film.to_image(r.render_state(ctx, sample_stop=samples))
    finally:
        P.PathIntegrator.kernel_route = orig


@pytest.mark.parametrize("name,slab", [("matte dragon", True),
                                       ("cornell-box", False),
                                       ("gallery", True)])
def test_route_render_is_the_general_chain(name, slab, monkeypatch):
    """(The closed Cornell box keeps most lanes alive: its interior runs
    at full width, one 4096-lane tile.)"""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 128)
    lanes = 256 if slab else 4096
    calls = {}
    for fn in ("path_hit_emit", "path_scatter_lambert", "path_nee_add"):
        orig = getattr(PS, fn)

        def counted(*a, _fn=fn, _orig=orig, **k):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(PS, fn, counted)
    scene = _scene(name)
    assert scene[4].kernel_route(scene[0])
    P.reset_tiers()
    img = _render(scene, True, 1, lanes)
    assert len(calls) == 3 and min(calls.values()) > 0, calls
    assert (P.TIERS[2] + P.TIERS[4] > 0) is slab, P.TIERS
    n_calls = dict(calls)
    ref = _render(scene, False, 1, lanes)
    assert calls == n_calls       # the general chain runs no twin
    assert torch.isfinite(img).all() and img.mean() > 1e-3
    assert torch.equal(img, ref)


def test_cornell_route_render_matches_jax():
    res = (32, 32)
    jctx, _, _, jsampler, jinteg = bench.build_cornell()
    jfilm = JaxFilm(full_resolution=res, filter=JaxFilter("box", 0.5, 0.5))
    jr = JaxRenderer(jinteg.li, jax_cornell_camera(res), jfilm, jsampler,
                     JaxRenderConfig(max_lanes=1 << 10, collect_stats=False))
    ref = np.asarray(jfilm.to_image(jr.render_state(jctx, sample_stop=2)))
    ctx, cam, film, sampler, integ = build_cornell(res=res, device="cpu")
    assert integ.kernel_route(ctx)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=1 << 10),
                 device="cpu")
    img = film.to_image(r.render_state(ctx, sample_stop=2)).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert ref.mean() > 1e-2
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()
