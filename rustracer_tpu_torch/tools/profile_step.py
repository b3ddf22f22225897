"""Render times and profiled render or train steps of the full-size
dragon or of a testball scene file, one GPU.

    python -m rustracer_tpu_torch.tools.profile_step
        [textured|matte|train|testball-<material>|cornell-box] [tile ...]
        [--general]

Builds the scene at 1024^2 in 2^18-lane tiles (the textured headline: the
64-spp config, compaction on; ``testball-<material>``:
scenes/testball-<material>.pbrt with its film at 1024^2, its own spp and
depth, or a ball of ``BALLS`` on testball-glass's stage). For
``textured``, ``matte`` and a testball it renders one sample of every
tile as a warm-up, then times five 8-sample renders (host clock ending in
``torch.cuda.synchronize()``) and prints them as one JSON
line. Then, for each tile index (default 0 and 2; tile 0 holds the sky and
takes a slab tier, tile 2 is all floor and dragon), it times one step at
sample 1 (median of 5) and profiles one more, and prints one JSON line per
tile: the step's wall time, the device busy time (the union of the kernels'
device intervals) and its share of the profiled step, the kernel count and
the ten largest device items, and the device time of each hand kernel
(K21-K23, the path chain's kernels, also summed). ``cornell-box`` is
scenes/cornell-box.pbrt as written (64^2, 16 spp: one 2^16-lane step).
``--general`` runs the path integrator's general chain where the scene
would take the kernel route (integrators/path.py kernel_route), for the
step's launches and idle share on both chains.

``train`` times three whole train steps of the textured dragon
(parallel/mesh.py make_train_step, lr 0.1, sample 0, the target its render
with the hero's albedo scaled by 0.5; tools/bench_fwdbwd.py) after a
warm-up, then, for each tile index (default 2), makes a train step of that
tile alone (the film cropped to its 256 rows), times it (median of 5) and
profiles one more: the same line as a render step's, with the share of
the busy time that the backward kernels K9-K11 take. Refuses to run
without CUDA.
"""
from __future__ import annotations

import json
import os
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


_MIX = ('MakeNamedMaterial "a" "string type" "substrate" {kd}'
        '"rgb Ks" [0.3 0.3 0.3] "float uroughness" [0.08] '
        '"float vroughness" [0.2]\n'
        'MakeNamedMaterial "b" "string type" "disney" '
        '"rgb color" [0.2 0.4 0.7] "float metallic" [0.3] '
        '"float roughness" [0.35] "float clearcoat" [0.6] "float sheen" [0.4]'
        '\n{amount_texture}'
        'Material "mix" "string namedmaterial1" "a" '
        '"string namedmaterial2" "b" {amount}')
_CHECKS = ('Texture "amt" "spectrum" "checkerboard" "float uscale" [8] '
           '"float vscale" [8] "rgb tex1" [0.15 0.2 0.25] '
           '"rgb tex2" [0.85 0.9 0.7]\n')
# balls without a scene file: testball-<name> is testball-glass with its
# ball's Material line replaced by BALLS[name]
BALLS = {
    "oren-nayar": 'Material "matte" "rgb Kd" [0.6 0.5 0.4] "float sigma" [20]',
    "translucent": 'Material "translucent" "rgb Kd" [0.5 0.3 0.2] '
                   '"rgb Ks" [0.3 0.3 0.3] "float roughness" [0.2] '
                   '"rgb reflect" [0.6 0.5 0.6] "rgb transmit" [0.4 0.4 0.3]',
    "uber": 'Material "uber" "rgb Kd" [0.4 0.3 0.2] "rgb Ks" [0.2 0.2 0.2] '
            '"rgb Kr" [0.2 0.2 0.2] "rgb Kt" [0.3 0.3 0.3] '
            '"rgb opacity" [0.5 0.5 0.5] "float roughness" [0.1]',
    "disney-thin": 'Material "disney" "rgb color" [0.3 0.5 0.7] '
                   '"float metallic" [0.2] "float roughness" [0.4] '
                   '"float spectrans" [0.3] "float flatness" [0.5] '
                   '"float difftrans" [0.6] "bool thin" "true" '
                   '"float sheen" [0.5] "float clearcoat" [0.5] '
                   '"float anisotropic" [0.4]',
    # substrate and Disney with a constant amount, with a checkerboard
    # amount (the mix shaded per lane), and over a substrate whose Kd is
    # the floor's checkerboard
    "mix-constant": _MIX.format(kd='"rgb Kd" [0.4 0.2 0.1] ',
                                amount_texture="",
                                amount='"rgb amount" [0.3 0.5 0.7]'),
    "mix": _MIX.format(kd='"rgb Kd" [0.4 0.2 0.1] ', amount_texture=_CHECKS,
                       amount='"texture amount" "amt"'),
    "mix-textured": _MIX.format(kd='"texture Kd" "checks" ',
                                amount_texture="",
                                amount='"rgb amount" [0.6 0.6 0.6]'),
}
_SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")


def scene_text(name):
    """The text of scenes/<name>.pbrt, or for testball-<b> with b in BALLS
    testball-glass's with that ball."""
    ball = BALLS.get(name[len("testball-"):])
    with open(os.path.join(_SCENES, "testball-glass.pbrt" if ball
                           else f"{name}.pbrt")) as f:
        text = f.read()
    return text.replace('Material "glass"', ball) if ball else text


def testball_text(name, res, spp=None):
    """-> (scene_text(name) with its 64^2 film at ``res`` (and ``spp``
    samples a pixel where given), the directory its textures are found
    from)."""
    text = scene_text(name)
    small = '"integer xresolution" [64] "integer yresolution" [64]'
    if small not in text:
        raise ValueError(f"{name}.pbrt's Film line changed")
    text = text.replace(small, f'"integer xresolution" [{res[0]}] '
                        f'"integer yresolution" [{res[1]}]')
    if spp is not None:
        if '"integer pixelsamples" [16]' not in text:
            raise ValueError(f"{name}.pbrt's Sampler line changed")
        text = text.replace('"integer pixelsamples" [16]',
                            f'"integer pixelsamples" [{spp}]')
    return text, _SCENES


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

    return profile_call(step, reps)


def profile_call(step, reps=5):
    """-> dict of the wall time of ``step()`` (which ends in a
    synchronize), median of ``reps``, and the device profile of one
    more."""
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
                busy_share=busy / (prof_wall * 1e3),
                idle_share=1.0 - busy / (prof_wall * 1e3),
                n_kernels=len(events),
                path_kernels_ms=round(sum(
                    ms for k, ms in hand.items()
                    if k.startswith(cuda.PATH_KERNELS)), 4),
                launches=dict(cuda.LAUNCHES), slab_tiers=dict(P.TIERS),
                top_device_ms=[[k, round(ms, 4)] for k, ms in top],
                hand_kernels_ms={k: round(ms, 4) for k, ms in hand.items()})


def profile_train(ctx, cam, full, sampler, integ, ti, reps=5):
    """-> dict of the wall time and device profile of a train step of
    tile ``ti`` alone (the film ``full`` cropped to the tile's rows)."""
    from ..parallel.mesh import make_train_step
    from ..render.film import Film
    from .bench_fwdbwd import half_albedo_target
    w, h = full.full_resolution
    rows = LANES // w
    film = Film(full_resolution=(w, h), filter=full.filter,
                crop_window=(0.0, ti * rows / h, 1.0, (ti + 1) * rows / h))
    config = RenderConfig(max_lanes=LANES)
    target = half_albedo_target(Renderer(integ.li, cam, film, sampler,
                                         config, device=ctx.geom.tv_p.device),
                                ctx)
    train = make_train_step(integ.li, cam, film, sampler, lr=0.1,
                            config=config, device=ctx.geom.tv_p.device)

    def step():
        _, loss = train(ctx, target)
        loss.item()

    step()                                # warm-up
    r = profile_call(step, reps)
    busy = r["device_busy_ms"]
    bwd = {k: v for k, v in r["hand_kernels_ms"].items()
           if "_bwd_" in k}
    r.update(backward_kernels_ms=bwd,
             backward_kernels_share=sum(bwd.values()) / busy)
    return r


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device; nothing runs on the "
                         "CPU")
    general = "--general" in argv
    if general:
        argv = [a for a in argv if a != "--general"]
        P.PathIntegrator.kernel_route = lambda self, ctx: False
    scene = argv[0] if argv else "textured"
    dev = torch.device("cuda:0")
    if scene == "train":
        return main_train([int(a) for a in argv[1:]] or [2], dev)
    tiles = [int(a) for a in argv[1:]] or [0, 2]
    if scene.startswith("testball-") or scene == "cornell-box":
        from ..scene.api import parse_scene_string
        from ..utils import fileutil
        text, d = testball_text(scene, (1024, 1024)) \
            if scene.startswith("testball-") else (scene_text(scene), _SCENES)
        fileutil.set_search_directory(d)
        bundle = parse_scene_string(text, device=dev).scene
        ctx, film = bundle.context(), bundle.film
        renderer = bundle.renderer(LANES)
        tiles = [t for t in tiles if t < len(renderer.tiles)]
    else:
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
    out = [dict(scene=scene, chain="general" if general else "kernel route",
                samples=SAMPLES, render_s=walls,
                median_s=statistics.median(walls),
                rays_per_s=rays / statistics.median(walls),
                card=torch.cuda.get_device_name(0))]
    print(json.dumps(out[0]), flush=True)
    for ti in tiles:
        r = dict(scene=scene, tile=ti, lanes=int(renderer.tiles[ti][0].numel()),
                 chain="general" if general else "kernel route",
                 card=torch.cuda.get_device_name(0),
                 **profile_tile(renderer, ctx, renderer.tiles[ti]))
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


def main_train(tiles, dev):
    from ..scenes import dragon_geometry
    from .bench_fwdbwd import bench_dragon_step
    geometry = dragon_geometry(device=dev)
    ctx, cam, film, sampler, integ, _ = build_dragon(device=dev,
                                                     geometry=geometry)
    whole = bench_dragon_step(dev, runs=3, geometry=geometry)
    out = [dict(scene="train", card=torch.cuda.get_device_name(0),
                step_s=whole["step_s"], times_s=whole["times_s"],
                peak_bytes=whole["peak_bytes"])]
    print(json.dumps(out[0]), flush=True)
    for ti in tiles:
        r = dict(scene="train", tile=ti, lanes=LANES,
                 card=torch.cuda.get_device_name(0),
                 **profile_train(ctx, cam, film, sampler, integ, ti))
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
