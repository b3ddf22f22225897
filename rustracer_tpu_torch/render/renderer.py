"""Wavefront renderer (port of rustracer_tpu/render/renderer.py): the padded
tile decomposition of the film's sample bounds, and one integrator call per
(tile, sample): camera sample -> ray -> Li -> scrub -> film splat."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .camera import PerspectiveCamera
from .film import Film, FilmState
from .sampler import DimAllocator, SamplerConfig


@dataclasses.dataclass
class Lanes:
    pixel_idx: torch.Tensor   # (B,) int64 linear pixel index (uint32 value)
    sample_idx: torch.Tensor  # (B,) int64 sample index


@dataclasses.dataclass
class RenderContext:
    geom: Any
    lights: Any = None
    textures: Any = None     # {"const": {key: (3,) tensor}}
    light_grid: Any = None   # scene/lightdistrib.py SpatialLightGrid


@dataclasses.dataclass
class RenderConfig:
    max_lanes: int = 1 << 16    # pixels per tile


def scrub_radiance(L, valid=None):
    """Zero non-finite or negative radiance."""
    bad = ~torch.all(torch.isfinite(L), dim=-1) | torch.any(L < 0.0, dim=-1)
    L = torch.where(bad[:, None], 0.0, L)
    if valid is not None:
        L = torch.where(valid[:, None], L, 0.0)
    return L


class Renderer:
    """Renders a film's sample bounds tile by tile on ``device``."""

    def __init__(self, li_fn, camera: PerspectiveCamera, film: Film,
                 sampler: SamplerConfig, config: Optional[RenderConfig] = None,
                 device="cuda"):
        self.li_fn = li_fn
        self.camera = camera
        self.film = film
        self.sampler = sampler
        self.config = config or RenderConfig()
        self.device = torch.device(device)
        x0, y0, x1, y1 = film.get_sample_bounds()
        gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                             np.arange(y0, y1, dtype=np.int32))
        px_all, py_all = gx.ravel(), gy.ravel()
        n = px_all.size
        tile = min(self.config.max_lanes, n)
        n_tiles = -(-n // tile)
        pad = n_tiles * tile - n
        valid = np.ones(n, bool)
        if pad:
            px_all = np.concatenate([px_all, np.full(pad, x0, np.int32)])
            py_all = np.concatenate([py_all, np.full(pad, y0, np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        self.tiles = [
            tuple(torch.as_tensor(a[ti * tile:(ti + 1) * tile],
                                  device=self.device)
                  for a in (px_all, py_all, valid))
            for ti in range(n_tiles)]

    def step(self, ctx: RenderContext, fs: FilmState, px, py, s: int, v):
        """One integrator call over a tile at sample index s."""
        xr, _ = self.film.full_resolution
        pixel_idx = (py.long() * xr + px.long()) & 0xFFFFFFFF
        lanes = Lanes(pixel_idx=pixel_idx,
                      sample_idx=torch.full_like(pixel_idx, s))
        pixel_xy = torch.stack([px, py], dim=-1).float()
        p_film, p_lens, _time = self.sampler.get_camera_sample(
            pixel_xy, lanes.pixel_idx, lanes.sample_idx)
        ray = self.camera.generate_ray_differential(p_film, p_lens)
        ray = ray.scaled_differentials(1.0 / np.sqrt(max(1, self.sampler.spp)))
        L = scrub_radiance(self.li_fn(ctx, ray, lanes, self.sampler,
                                      DimAllocator()))
        return self.film.add_samples(fs, p_film, L, valid=v)

    def render_state(self, ctx: RenderContext, film_state=None,
                     sample_start: int = 0,
                     sample_stop: Optional[int] = None) -> FilmState:
        """Accumulate samples [sample_start, sample_stop) into film state."""
        if film_state is None:
            film_state = self.film.init_state(self.device)
        stop = self.sampler.spp if sample_stop is None else sample_stop
        for px, py, v in self.tiles:
            for s in range(sample_start, stop):
                film_state = self.step(ctx, film_state, px, py, s, v)
        return film_state

    def render(self, ctx: RenderContext):
        """Full render -> (H, W, 3) linear RGB tensor."""
        return self.film.to_image(self.render_state(ctx))
