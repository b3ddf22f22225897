"""Render times and profiled render steps of the full-size dragon, one GPU.

    python -m rustracer_tpu_torch.tools.profile_step [textured|matte] [tile ...]

Builds the scene at 1024^2 in 2^18-lane tiles (the textured headline: the
64-spp config, compaction on), renders one sample of every tile as a
warm-up, then times five 8-sample renders (host clock ending in
``torch.cuda.synchronize()``) and prints them as one JSON line. Then, for
each tile index (default 0 and 2; tile 0 holds the sky and takes a slab
tier, tile 2 is all floor and dragon), it times one step at sample 1
(median of 5) and profiles one more, and prints one JSON line per tile: the
step's wall time, the device busy time (the union of the kernels' device
intervals) and its share of the profiled step, the kernel count and the ten
largest device items, and the device time of each hand kernel. Refuses to
run without CUDA.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from .. import cuda
from ..integrators import path as P
from ..render.renderer import RenderConfig, Renderer
from ..scenes import build_dragon, build_dragon_matte

LANES = 1 << 18
SAMPLES = 8      # the timed slice of the 64-spp config


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(events):
    """Length of the union of the events' device intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_tile(renderer, ctx, tile, reps=5):
    """-> dict of one step's wall time and its device profile."""
    px, py, v = tile

    def step():
        fs = renderer.film.init_state(renderer.device)
        renderer.step(ctx, fs, px, py, 1, v)
        torch.cuda.synchronize()

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    cuda.reset_launches()
    P.reset_tiers()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        prof_wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = _busy_us(events) * 1e-3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # the hand kernels of csrc/ live in anonymous namespaces
    hand = {}
    for k, ms in by_name.items():
        if "(anonymous namespace)::" in k and "at::native" not in k:
            short = k.split("::", 1)[1].split("(")[0]
            hand[short] = hand.get(short, 0.0) + ms
    return dict(step_ms_median=statistics.median(walls) * 1e3,
                step_ms_all=[w * 1e3 for w in walls],
                profiled_step_ms=prof_wall * 1e3, device_busy_ms=busy,
                busy_share=busy / (prof_wall * 1e3), n_kernels=len(events),
                launches=dict(cuda.LAUNCHES), slab_tiers=dict(P.TIERS),
                top_device_ms=[[k, round(ms, 4)] for k, ms in top],
                hand_kernels_ms={k: round(ms, 4) for k, ms in hand.items()})


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device; nothing runs on the "
                         "CPU")
    scene = argv[0] if argv else "textured"
    tiles = [int(a) for a in argv[1:]] or [0, 2]
    dev = torch.device("cuda:0")
    build = {"textured": build_dragon, "matte": build_dragon_matte}[scene]
    ctx, cam, film, sampler, integ, _ = build(device=dev)
    renderer = Renderer(integ.li, cam, film, sampler,
                        RenderConfig(max_lanes=LANES), device=dev)
    renderer.render_state(ctx, sample_stop=1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        film.to_image(renderer.render_state(ctx, sample_stop=SAMPLES))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rays = film.full_resolution[0] * film.full_resolution[1] * SAMPLES
    out = [dict(scene=scene, samples=SAMPLES, render_s=walls,
                median_s=statistics.median(walls),
                rays_per_s=rays / statistics.median(walls),
                card=torch.cuda.get_device_name(0))]
    print(json.dumps(out[0]), flush=True)
    for ti in tiles:
        r = dict(scene=scene, tile=ti, lanes=LANES,
                 card=torch.cuda.get_device_name(0),
                 **profile_tile(renderer, ctx, renderer.tiles[ti]))
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
