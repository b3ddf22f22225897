#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rustracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the hand kernels from rustracer_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     render path's shapes on the full 327,680-triangle matte dragon, with
     kernel and plain times;
  4. the matte dragon at 1024^2, 8 spp, depth 5 through the Renderer, with
     every kernel's launch count from that run;
  5. a 128^2 crop at 1 spp, kernel path against the all-plain path, within
     the golden-image tolerance of tests/test_golden.py;
  6. a JSON line of the kernels, the card line, and the result line.
Any failed check raises; there is no CPU fallback.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

SUB = 7          # bumpy_sphere(7): 327,680 mesh triangles
RES = (1024, 1024)
SPP = 8
LANES = 1 << 18
CROP = (0.4375, 0.4375, 0.5625, 0.5625)     # 128^2 around the image centre
SOURCES = {
    "sample_1d": ("rustracer_tpu_torch/csrc/sampler.cu",
                  "rustracer_tpu/render/sampler.py:34"),
    "sample_2d": ("rustracer_tpu_torch/csrc/sampler.cu",
                  "rustracer_tpu/render/sampler.py:40"),
    "traverse16_closest": ("rustracer_tpu_torch/csrc/traverse16.cu",
                           "rustracer_tpu/accel/traverse16.py:137"),
    "traverse16_any": ("rustracer_tpu_torch/csrc/traverse16.cu",
                       "rustracer_tpu/accel/traverse16.py:137"),
    "build_interaction_tri": ("rustracer_tpu_torch/csrc/interaction.cu",
                              "rustracer_tpu/scene/tables.py:549"),
    "film_add_samples": ("rustracer_tpu_torch/csrc/film.cu",
                         "rustracer_tpu/render/film.py:67"),
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps):
    """Mean device time of fn over reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def both(fn, reps, plain_reps=None):
    """-> (kernel output, plain output, kernel ms, plain ms)."""
    from rustracer_tpu_torch.cuda import plain_reference
    out = fn()
    with plain_reference():
        ref = fn()
        plain_ms = time_ms(fn, plain_reps or reps)
    return out, ref, time_ms(fn, reps), plain_ms


def check_kernels(ctx, cam, film, sampler, renderer, results):
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.accel.traverse16 import traverse16
    from rustracer_tpu_torch.core.math import normalize
    from rustracer_tpu_torch.core.ray import Ray
    from rustracer_tpu_torch.scene.tables import build_interaction

    dev = ctx.geom.tv_p.device
    px, py, valid = renderer.tiles[len(renderer.tiles) // 2]
    pixel_idx = (py.long() * RES[0] + px.long())
    sample_idx = torch.full_like(pixel_idx, 3)
    pixel_xy = torch.stack([px, py], -1).float()

    # K3: sampler dims, bit-equal
    for name, fn in (("sample_1d", lambda: sampler.get_1d(pixel_idx,
                                                          sample_idx, 5)),
                     ("sample_2d", lambda: sampler.get_2d(pixel_idx,
                                                          sample_idx, 6))):
        out, ref, ms, pms = both(fn, 20)
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{name}: kernel and plain differ in bits")
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms)
        log(f"[3] {name}: bit-equal on {LANES} lanes; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")

    # camera rays of this tile, and random bounce rays from their hits
    p_film = pixel_xy + sampler.get_2d(pixel_idx, sample_idx, 0)
    cam_ray = cam.generate_ray_differential(p_film)
    hit, t, tid = traverse16(ctx.geom, cam_ray.o, cam_ray.d, cam_ray.t_max,
                             any_hit=False)
    prim = torch.where(hit, tid + ctx.geom.n_quadrics, 0)
    si = build_interaction(ctx.geom, cam_ray, hit, t, prim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    w = normalize(torch.randn((LANES, 3), generator=gen, device=dev))
    w = torch.where(((w * si.n).sum(-1) < 0)[:, None], -w, w)
    bounce = si.spawn_ray(w)
    bounce = Ray(o=torch.where(si.valid[:, None], bounce.o, cam_ray.o),
                 d=w.contiguous(), t_max=bounce.t_max)
    log(f"[3] camera rays hit {hit.float().mean().item():.4f} of the tile")

    # K1: closest and any hit on both wavefronts
    for name, any_hit in (("traverse16_closest", False),
                          ("traverse16_any", True)):
        err, ms_sum, pms_sum = 0.0, 0.0, 0.0
        for label, ray in (("camera", cam_ray), ("bounce", bounce)):
            def fn(ray=ray):
                return traverse16(ctx.geom, ray.o, ray.d, ray.t_max,
                                  any_hit=any_hit, with_counts=True)
            (h, tt, p, c), (rh, rt, rp, rc), ms, pms = both(fn, 10, 1)
            same = (h == rh) & (~h | (p == rp))
            frac = same.float().mean().item()
            m = h & rh & (p == rp)
            rel = ((tt[m] - rt[m]).abs() / rt[m].abs().clamp(min=1e-30))
            rel = rel.max().item() if m.any() else 0.0
            err = max(err, (tt[m] - rt[m]).abs().max().item()
                      if m.any() else 0.0)
            ms_sum += ms
            pms_sum += pms
            log(f"[3] {name} {label}: hit&prim equal {frac:.6f}, t rel err "
                f"{rel:.3g}, hits {h.float().mean().item():.4f}, counts "
                f"kernel {c.tolist()} plain {rc.tolist()}; kernel {ms:.3f} "
                f"ms, plain {pms:.3f} ms")
            if frac < 0.9999:
                raise AssertionError(f"{name} {label}: hit/prim agree on "
                                     f"{frac:.6f} < 0.9999 of rays")
            if not any_hit and rel > 1e-6:
                raise AssertionError(f"{name} {label}: t rel err {rel}")
        results[name] = dict(max_abs_err=err, ms=ms_sum / 2,
                             plain_ms=pms_sum / 2)

    # K2: every interaction field within 1e-5 abs or rel
    def k2():
        return build_interaction(ctx.geom, cam_ray, hit, t, prim)
    out, ref, ms, pms = both(k2, 20)
    err = 0.0
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        a, b = getattr(out, f), getattr(ref, f)
        d = (a - b).abs()
        bad = (d > 1e-5) & (d > 1e-5 * b.abs())
        if bad.any():
            raise AssertionError(f"build_interaction_tri: {f} differs on "
                                 f"{int(bad.sum())} lanes, max {d.max()}")
        err = max(err, d.max().item())
    for f in ("material", "arealight", "prim_id"):
        if not torch.equal(getattr(out, f), getattr(ref, f)):
            raise AssertionError(f"build_interaction_tri: {f} differs")
    results["build_interaction_tri"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=pms)
    log(f"[3] build_interaction_tri: fields max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms")

    # K4: splat into the full film, within 1e-5 relative
    rad = torch.rand((LANES, 3), generator=gen, device=dev) * 4.0

    out = film.add_samples(film.init_state(dev), p_film, rad, valid=valid)
    with K.plain_reference():
        ref = film.add_samples(film.init_state(dev), p_film, rad, valid=valid)
    acc = film.init_state(dev)

    def k4():
        return film.add_samples(acc, p_film, rad, valid=valid)
    _, _, ms, pms = both(k4, 20)
    d = (out.rgb - ref.rgb).abs()
    if ((d > 1e-5 * ref.rgb.abs()) & (d > 1e-6)).any() or \
            not torch.allclose(out.wsum, ref.wsum, rtol=1e-5):
        raise AssertionError(f"film_add_samples differs, max {d.max()}")
    results["film_add_samples"] = dict(max_abs_err=d.max().item(), ms=ms,
                                       plain_ms=pms)
    log(f"[3] film_add_samples: max abs err {d.max().item():.3g}; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing runs on the CPU")
    from rustracer_tpu_torch import cuda as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    path = K.library_path()
    K.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{path}")
    run(torch.device("cuda:0"), card)


def run(dev, card):
    """Phases 3 to 6 on device ``dev``."""
    from rustracer_tpu_torch import cuda as K
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.filters import Filter
    from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
    from rustracer_tpu_torch.scenes import build_dragon_matte

    t0 = time.perf_counter()
    ctx, cam, film, sampler, integ, n_tris = build_dragon_matte(
        sub=SUB, res=RES, spp=SPP, device=dev)
    log(f"[3] matte dragon: {n_tris} triangles, BVH depth "
        f"{ctx.geom.bvh16_depth}, {ctx.geom.bvh16_table.shape[0]} records, "
        f"built in {time.perf_counter() - t0:.1f} s")
    renderer = Renderer(integ.li, cam, film, sampler,
                        RenderConfig(max_lanes=LANES), device=dev)
    results = {}
    check_kernels(ctx, cam, film, sampler, renderer, results)

    # 4: the main path, counted
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    img = film.to_image(renderer.render_state(ctx))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    mean = img.mean().item()
    log(f"[4] render {RES[0]}x{RES[1]} {SPP} spp depth {integ.max_depth}: "
        f"{wall:.3f} s wall, {RES[0] * RES[1] * SPP / wall:.1f} camera "
        f"rays/s, image mean {mean:.5f} on {card}")
    log(f"[4] launches: {launches}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite radiance in the render")
    if not mean > 1e-4:
        raise AssertionError(f"render is black (mean {mean})")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the render: {missing}")

    # 5: kernel path against the all-plain path on a 128^2 crop, 1 spp
    crop_film = Film(full_resolution=RES, crop_window=CROP,
                     filter=Filter("box", 0.5, 0.5))
    crop = Renderer(integ.li, cam, crop_film, sampler,
                    RenderConfig(max_lanes=LANES), device=dev)
    t0 = time.perf_counter()
    img_k = crop_film.to_image(crop.render_state(ctx, sample_stop=1))
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    with K.plain_reference():
        img_p = crop_film.to_image(crop.render_state(ctx, sample_stop=1))
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    err = (img_k - img_p).abs()
    scale = max(img_p.mean().item(), 1e-3)
    mean_err = err.mean().item() / scale
    p99 = float(np.percentile(err.cpu().numpy(), 99)) / scale
    log(f"[5] crop {tuple(img_k.shape)} 1 spp: mean err {mean_err:.3g} "
        f"(<= 2e-3), p99 {p99:.3g} (<= 2e-2); kernel path {t_k:.3f} s, "
        f"plain path {t_p:.3f} s")
    if not (mean_err <= 2e-3 and p99 <= 2e-2):
        raise AssertionError("kernel and plain renders disagree")

    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
               for k in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
