"""Command-line renderer of PBRT scenes (port of rustracer_tpu/utils/cli.py).

    python -m rustracer_tpu_torch.utils.cli scene.pbrt [-o out.exr] [--spp N]
        [--quick] [-t LOG2_LANES] [-v] [--cpu] [--checkpoint PATH]
        [--checkpoint-every SPP] [--profile DIR]

Parses the scene, renders it on the card (the CPU with ``--cpu``) and
writes the image with the port's image writers (PNG, TGA or EXR by the
output's extension; the scene's film filename by default). Prints a
progress line per tile, the phase timings (parse, BVH build, spatial light
grid, render) and the reference's counter table (utils/stats.py); ``-v``
adds the hand kernels' launch counts of the scene build and render as a
JSON line. ``--checkpoint PATH`` renders with film checkpoints: it resumes
from PATH if it exists, writes PATH every ``--checkpoint-every`` samples
and removes it at the end. ``--profile DIR`` records the render with
torch.profiler (CPU activities and, on the card, CUDA activities) and
writes a Chrome trace into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="rustracer-tpu-torch",
        description="PyTorch/CUDA path tracer of PBRT scenes")
    p.add_argument("scene", help="PBRT scene file")
    p.add_argument("-o", "--output", default=None,
                   help="override output image filename")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="log2 of the lanes of a tile (the reference's "
                        "thread count)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain PyTorch versions of "
                        "the kernels)")
    p.add_argument("--spp", type=int, default=None,
                   help="override samples/pixel")
    p.add_argument("--quick", action="store_true",
                   help="quick render: spp/4")
    p.add_argument("--progress", action="store_true", default=True)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="film checkpoint file: resume if present, snapshot "
                        "periodically, removed at the end")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="SPP",
                   help="samples/pixel between checkpoints (default 8)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "to DIR")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    import numpy as np
    import torch

    from .. import cuda
    from ..render.imageio import write_image
    from ..scene.api import parse_scene
    from .stats import init_stats, print_phases, print_stats, time_phase

    device = "cpu" if args.cpu else "cuda"
    init_stats()
    cuda.reset_launches()
    t0 = time.time()
    try:
        api = parse_scene(args.scene, options={"quick_render": args.quick},
                          device=device)
    except NotImplementedError as e:
        print(f"{args.scene}: {e}", file=sys.stderr)
        return 3
    bundle = api.scene
    if bundle is None:
        print("scene did not call WorldEnd; nothing to render",
              file=sys.stderr)
        return 1
    print(f"scene built in {time.time() - t0:.2f}s")
    if args.spp:
        bundle.sampler = dataclasses.replace(bundle.sampler, spp=args.spp)
    max_lanes = 1 << 16
    if args.threads:
        max_lanes = 1 << max(10, min(22, args.threads))

    t1 = time.time()
    with profiled(args.profile, device) as prof, time_phase("render"):
        img = bundle.render(progress=args.progress, max_lanes=max_lanes,
                            checkpoint=args.checkpoint,
                            checkpoint_every=args.checkpoint_every)
        if img.device.type == "cuda":
            torch.cuda.synchronize()
    if prof is not None:
        print(f"wrote a torch.profiler trace to {prof}")
    img = np.asarray(img.cpu())
    print(f"render time: {time.time() - t1:.2f}s")
    if args.verbose:
        print("launches " + json.dumps(dict(cuda.LAUNCHES)))
    out = args.output or bundle.filename
    write_image(out, img)
    print(f"wrote {out}")
    print_phases()
    print_stats()
    return 0


@contextlib.contextmanager
def profiled(trace_dir, device):
    """With ``trace_dir`` a directory: a torch.profiler record of the block
    (CPU activities, and CUDA activities on the card; each kernel launch a
    range named after its entry point), written there as a Chrome trace
    whose path is the context value (None without ``trace_dir``)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from .. import cuda
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device == "cuda" else [])
    path = os.path.join(trace_dir, "render.trace.json")
    with profile(activities=acts) as prof, cuda.annotated():
        yield path
    prof.export_chrome_trace(path)


if __name__ == "__main__":
    sys.exit(main())
