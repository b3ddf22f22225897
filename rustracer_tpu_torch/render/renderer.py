"""Wavefront renderer (port of rustracer_tpu/render/renderer.py): the padded
tile decomposition of the film's sample bounds, and one integrator call per
(tile, sample): camera sample -> ray -> Li -> scrub -> film splat.

With ``RenderConfig.collect_stats`` (the default) each step adds the
reference's per-render counters (renderer.rs:17, path.rs:18-19) to the
device tape of utils/stats.py: camera rays (a host count of the tile's
valid lanes), the paths of nonzero radiance, and the path-length sum,
minimum and maximum where the integrator returns its path lengths
(``li_aux``), beside what the integrator and the texture lookups count
there; ``render_state`` fetches them once, at its end, into the
registry. ``render_checkpointed`` snapshots the film state every few
samples (render/checkpoint.py), splatting through K4d.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from ..utils import stats as S
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
    report_progress: bool = False   # a line per tile
    collect_stats: bool = True      # the per-render counters


def scrub_radiance(L, valid=None):
    """Zero non-finite or negative radiance."""
    bad = ~torch.all(torch.isfinite(L), dim=-1) | torch.any(L < 0.0, dim=-1)
    L = torch.where(bad[:, None], 0.0, L)
    if valid is not None:
        L = torch.where(valid[:, None], L, 0.0)
    return L


class Renderer:
    """Renders a film's sample bounds tile by tile on ``device``. ``li_fn``
    returns the radiance (B, 3), or (radiance, path lengths (B,)) as the
    path integrator's ``li_aux`` does; ``tests_per_lane`` (regular and
    shadow tests a camera ray dispatches, or None) feeds the dispatched
    bounds of the counters."""

    def __init__(self, li_fn, camera: PerspectiveCamera, film: Film,
                 sampler: SamplerConfig, config: Optional[RenderConfig] = None,
                 device="cuda", tests_per_lane=None):
        self.li_fn = li_fn
        self.camera = camera
        self.film = film
        self.sampler = sampler
        self.config = config or RenderConfig()
        self.device = torch.device(device)
        self.tests_per_lane = tests_per_lane
        x0, y0, x1, y1 = film.get_sample_bounds()
        gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                             np.arange(y0, y1, dtype=np.int32))
        px_all, py_all = gx.ravel(), gy.ravel()
        n = px_all.size
        tile = min(self.config.max_lanes, n)
        n_tiles = -(-n // tile)
        pad = n_tiles * tile - n
        valid = np.ones(n, bool)
        # each tile's valid lanes (all but the last tile's padding)
        self.tile_valid = [min(tile, n - ti * tile) for ti in range(n_tiles)]
        if pad:
            px_all = np.concatenate([px_all, np.full(pad, x0, np.int32)])
            py_all = np.concatenate([py_all, np.full(pad, y0, np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        self.tiles = [
            tuple(torch.as_tensor(a[ti * tile:(ti + 1) * tile],
                                  device=self.device)
                  for a in (px_all, py_all, valid))
            for ti in range(n_tiles)]
        # each tile's first lane: its index in the row-major sample bounds
        self.tile_first = [ti * tile for ti in range(n_tiles)]

    def step(self, ctx: RenderContext, fs: FilmState, px, py, s: int, v,
             first: Optional[int] = None, n_valid: Optional[int] = None):
        """One integrator call over a tile at sample index s; splat through
        K4, or through K4d given the tile's ``first`` lane. Adds the step's
        counters to an open device tape (``n_valid``: the tile's valid
        lanes, if known)."""
        xr, _ = self.film.full_resolution
        pixel_idx = (py.long() * xr + px.long()) & 0xFFFFFFFF
        lanes = Lanes(pixel_idx=pixel_idx,
                      sample_idx=torch.full_like(pixel_idx, s))
        pixel_xy = torch.stack([px, py], dim=-1).float()
        p_film, p_lens, _time = self.sampler.get_camera_sample(
            pixel_xy, lanes.pixel_idx, lanes.sample_idx)
        ray = self.camera.generate_ray_differential(p_film, p_lens)
        ray = ray.scaled_differentials(1.0 / np.sqrt(max(1, self.sampler.spp)))
        out = self.li_fn(ctx, ray, lanes, self.sampler, DimAllocator())
        L, path_len = out if isinstance(out, tuple) else (out, None)
        L = scrub_radiance(L)
        if S.counting():
            count_step(S._tape, v, L, path_len, n_valid)
        if first is None:
            return self.film.add_samples(fs, p_film, L, valid=v)
        return self.film.add_samples_det(fs, p_film, L, v, first)

    def render_state(self, ctx: RenderContext, film_state=None,
                     sample_start: int = 0,
                     sample_stop: Optional[int] = None,
                     deterministic: bool = False) -> FilmState:
        """Accumulate samples [sample_start, sample_stop) into film state
        (K4d's splat where ``deterministic``); with ``collect_stats`` the
        counters go to the registry of utils/stats.py, fetched once."""
        if film_state is None:
            film_state = self.film.init_state(self.device)
        stop = self.sampler.spp if sample_stop is None else sample_stop
        tape = S.device_tape_begin() if self.config.collect_stats else None
        t0 = time.perf_counter()
        try:
            for ti, ((px, py, v), first) in enumerate(zip(self.tiles,
                                                          self.tile_first)):
                for s in range(sample_start, stop):
                    film_state = self.step(ctx, film_state, px, py, s, v,
                                           first if deterministic else None,
                                           self.tile_valid[ti])
                if self.config.report_progress:
                    done = (ti + 1) / len(self.tiles)
                    el = time.perf_counter() - t0
                    print(f"  tile {ti + 1}/{len(self.tiles)} "
                          f"({100 * done:.0f}%) elapsed {el:.1f}s eta "
                          f"{el / done - el:.1f}s", flush=True)
        finally:
            if tape is not None:
                S.device_tape_end()
        if tape is not None:
            report_stats(tape, self.tests_per_lane)
        return film_state

    def render(self, ctx: RenderContext):
        """Full render -> (H, W, 3) linear RGB tensor."""
        return self.film.to_image(self.render_state(ctx))

    def render_checkpointed(self, ctx: RenderContext, ckpt_path: str,
                            every_spp: int = 8):
        """Render with film checkpoints (render/checkpoint.py): resume from
        ``ckpt_path`` if it exists, snapshot every ``every_spp`` samples,
        remove the file once the render is done -> (H, W, 3) image."""
        from .checkpoint import maybe_resume, save_film_checkpoint
        film_state, done = maybe_resume(ckpt_path, self.film, self.device)
        if done:
            print(f"resuming from {ckpt_path} at {done} spp", flush=True)
        spp = self.sampler.spp
        while done < spp:
            stop = min(done + max(1, every_spp), spp)
            film_state = self.render_state(ctx, film_state, done, stop,
                                           deterministic=True)
            done = stop
            if done < spp:
                save_film_checkpoint(ckpt_path, film_state, done)
        img = self.film.to_image(film_state)
        if os.path.exists(ckpt_path):
            os.remove(ckpt_path)
        return img


def count_step(tape: S.DeviceTape, valid, L, path_len, n_valid=None):
    """One step's counters onto ``tape``, then its end of step: camera
    rays (``n_valid``, the valid lanes' count, where the caller knows it),
    the paths of nonzero radiance (L is scrubbed: finite and not negative,
    so its largest channel is positive exactly where a channel is) and,
    given the lanes' path lengths, their sum, minimum and maximum, over
    the valid lanes. A tile with no padding skips the valid mask."""
    full = n_valid == valid.shape[0]
    lit = L.amax(-1) > 0.0
    tape.add("camera rays", n_valid if n_valid is not None else valid.sum())
    tape.add("nonzero radiance", (lit if full else lit & valid).sum())
    if path_len is not None:
        pl = path_len.long()
        if full:
            lo, hi = torch.aminmax(pl)
        else:
            lo = torch.where(valid, pl, 1 << 30).min()
            hi = torch.where(valid, pl, -1).max()
            pl = torch.where(valid, pl, 0)
        tape.add("path length", pl.sum())
        tape.min("path length", lo)
        tape.max("path length", hi)
    tape.end_step()


def report_stats(tape: S.DeviceTape, tests_per_lane=None):
    """The counters of a render's tape into the registry, under the JAX
    package's names (its renderer.py _report_stats): the per-step counters
    and the dispatched bounds, and every named count the integrator and
    the texture lookups added ("Category/Title")."""
    sums, mins, maxs = tape.fetch()
    cam = sums.pop("camera rays", 0)
    if not cam:
        return
    S.counter_add("Integrator/Camera rays traced", cam)
    S.percent_report("Integrator/Zero-radiance paths",
                     cam - sums.pop("nonzero radiance", 0), cam)
    if "path length" in sums:
        s, c, lo, hi = S._distributions.get("Integrator/Path length",
                                            (0, 0, 1 << 62, -(1 << 62)))
        S._distributions["Integrator/Path length"] = (
            s + sums.pop("path length"), c + cam,
            min(lo, mins["path length"]), max(hi, maxs["path length"]))
    if tests_per_lane:
        S.counter_add("Intersections/Regular traversals (dispatched bound)",
                      cam * tests_per_lane.get("regular", 0))
        S.counter_add("Intersections/Shadow traversals (dispatched bound)",
                      cam * tests_per_lane.get("shadow", 0))
    for name, v in sums.items():
        S.counter_add(name, v)
