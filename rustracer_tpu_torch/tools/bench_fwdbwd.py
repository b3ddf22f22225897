"""Forward+backward timings of the gradient path on one GPU.

    python -m rustracer_tpu_torch.tools.bench_fwdbwd [--runs N] [--json PATH]

1. The Cornell box's fwd+bwd loss of ``bench.py`` bench_cornell_fwdbwd
   (:265-337): 256^2, the (0,2) sampler, depth 5, compaction off, the red
   and green walls atlas imagemaps (8x8 noisy pyramids); the loss is the
   mean over pixels of the squared 4-sample mean radiance (one wavefront of
   every pixel a sample), differentiated with respect to the float leaves
   of ``ctx.textures``. A warm-up call, then the best of ``--runs``:
   W * H * 4 / t camera rays per second.
2. One train step of the textured dragon (``parallel/mesh.py``
   make_train_step, lr 0.1): 1024^2, the 64-spp config's sample 0, 2^18-lane
   tiles, compaction on, the target the port's own render with the hero's
   albedo scaled by 0.5. A warm-up step, then the best of ``--runs`` (host
   clock ending in ``torch.cuda.synchronize()``), with the peak of
   ``torch.cuda.max_memory_allocated``.

Prints one line for each and a JSON line of both (also written to
``--json``), with the card's name and power limit. Refuses to run without
CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..parallel.mesh import float_leaves, make_train_step
from ..render.renderer import Lanes, RenderConfig, Renderer, scrub_radiance
from ..render.sampler import DimAllocator
from ..scenes import build_cornell, build_dragon

SPP_BWD = 4            # bench.py: the fwd+bwd metric's 4-spp loss
CORNELL_WALLS = (1, 2)
DRAGON_LANES = 1 << 18


def cornell_loss(ctx, cam, film, sampler, integ, spp=SPP_BWD):
    """-> loss(textures): bench_cornell_fwdbwd's loss over every pixel of
    ``film`` (compaction off, as there)."""
    integ = dataclasses.replace(integ, compact_interior=False)
    dev = ctx.geom.tv_p.device
    xr, yr = film.full_resolution
    ys, xs = torch.meshgrid(torch.arange(yr, device=dev),
                            torch.arange(xr, device=dev), indexing="ij")
    pix = (ys.reshape(-1) * xr + xs.reshape(-1)).long()
    xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()

    def loss(textures):
        c = dataclasses.replace(ctx, textures=textures)
        total = 0.0
        for s in range(spp):
            lanes = Lanes(pixel_idx=pix, sample_idx=torch.full_like(pix, s))
            p_film, _, _ = sampler.get_camera_sample(xy, lanes.pixel_idx,
                                                     lanes.sample_idx)
            ray = cam.generate_ray_differential(p_film)
            total = total + scrub_radiance(
                integ.li(c, ray, lanes, sampler, DimAllocator()))
        return torch.mean((total / spp) ** 2)
    return loss


def value_and_grad(loss, textures):
    """-> (loss, gradients of the float leaves of ``textures``, in
    float_leaves order; zeros for a leaf the loss does not reach)."""
    leaves, rebuild = float_leaves(textures)
    theta = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        value = loss(rebuild(theta))
        grads = torch.autograd.grad(value, theta, allow_unused=True)
    return value.detach(), [torch.zeros_like(p) if g is None else g
                            for p, g in zip(theta, grads)]


def _best(fn, runs):
    fn()                                  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), times, out


def bench_cornell(dev, runs=3):
    ctx, cam, film, sampler, integ = build_cornell(
        imagemap_walls=CORNELL_WALLS, device=dev)
    loss = cornell_loss(ctx, cam, film, sampler, integ)
    best, times, (value, grads) = _best(
        lambda: value_and_grad(loss, ctx.textures), runs)
    w, h = film.full_resolution
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    return dict(rays_per_s=w * h * SPP_BWD / best, best_s=best, times_s=times,
                loss=value.item(), grads_finite=finite)


def half_albedo_target(renderer, ctx, scale_const=False):
    """A train step's target: ``renderer``'s image (sample 0) of ``ctx``
    with every pyramid level and, with ``scale_const``, every constant
    albedo scaled by 0.5."""
    tex = dict(ctx.textures)
    tex["images"] = [[0.5 * lv for lv in pyr] for pyr in tex["images"]]
    if scale_const:
        tex["const"] = {k: 0.5 * v for k, v in tex["const"].items()}
    with torch.no_grad():
        return renderer.film.to_image(renderer.render_state(
            dataclasses.replace(ctx, textures=tex), sample_stop=1))


def bench_dragon_step(dev, runs=3, res=(1024, 1024), lanes=DRAGON_LANES,
                      geometry=None):
    ctx, cam, film, sampler, integ, _ = build_dragon(res=res, device=dev,
                                                     geometry=geometry)
    config = RenderConfig(max_lanes=lanes)
    target = half_albedo_target(
        Renderer(integ.li, cam, film, sampler, config, device=dev), ctx)
    step = make_train_step(integ.li, cam, film, sampler, lr=0.1,
                           config=config, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    best, times, (new, loss) = _best(lambda: step(ctx, target), runs)
    peak = torch.cuda.max_memory_allocated(dev)
    old, _ = float_leaves(ctx.textures)
    grads = [(p - q) / 0.1 for p, q in zip(old, float_leaves(
        new.textures)[0])]
    return dict(step_s=best, times_s=times, loss=loss.item(),
                peak_bytes=peak,
                grads_finite=all(bool(torch.isfinite(g).all())
                                 for g in grads))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--json", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fwdbwd: no CUDA device; nothing runs on the "
                         "CPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cornell = bench_cornell(dev, args.runs)
    print(f"cornell fwd+bwd 256^2 x {SPP_BWD} spp: "
          f"{cornell['rays_per_s']:.1f} rays/s (best {cornell['best_s']:.4f}"
          f" s of {args.runs}), loss {cornell['loss']:.6g} on {card}",
          flush=True)
    dragon = bench_dragon_step(dev, args.runs)
    print(f"dragon train step 1024^2, 1 sample, 2^18-lane tiles: "
          f"{dragon['step_s']:.4f} s (best of {args.runs}), loss "
          f"{dragon['loss']:.6g}, peak {dragon['peak_bytes'] / 2 ** 30:.3f}"
          f" GiB on {card}", flush=True)
    out = dict(card=card, cornell=cornell, dragon=dragon)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not (cornell["grads_finite"] and dragon["grads_finite"]
            and np.isfinite(cornell["loss"]) and np.isfinite(dragon["loss"])):
        raise SystemExit("bench_fwdbwd: a non-finite loss or gradient")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
