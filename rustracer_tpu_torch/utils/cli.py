"""Command-line renderer of PBRT scenes (port of rustracer_tpu/utils/cli.py).

    python -m rustracer_tpu_torch.utils.cli scene.pbrt [-o out.exr] [--spp N]
        [--quick] [-t LOG2_LANES] [-v] [--cpu]

Parses the scene, renders it on the card (the CPU with ``--cpu``) and
writes the image with the port's image writers (PNG, TGA or EXR by the
output's extension; the scene's film filename by default). Prints the
phase timings (parse, BVH build, spatial light grid, render); ``-v`` adds
the hand kernels' launch counts of the scene build and render as a JSON
line.
``--checkpoint`` and ``--profile`` are not ported yet and exit with an
error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
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
                   help="not ported yet")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="SPP")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="not ported yet")
    args = p.parse_args(argv)
    for flag in ("checkpoint", "profile"):
        if getattr(args, flag):
            print(f"--{flag}: not ported (A17)", file=sys.stderr)
            return 2

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    import numpy as np
    import torch

    from .. import cuda
    from ..render.imageio import write_image
    from ..scene.api import parse_scene
    from .stats import init_stats, print_phases, time_phase

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
    with time_phase("render"):
        img = bundle.render(max_lanes=max_lanes)
        if img.device.type == "cuda":
            torch.cuda.synchronize()
    img = np.asarray(img.cpu())
    print(f"render time: {time.time() - t1:.2f}s")
    if args.verbose:
        print("launches " + json.dumps(dict(cuda.LAUNCHES)))
    out = args.output or bundle.filename
    write_image(out, img)
    print(f"wrote {out}")
    print_phases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
