"""K1 (the wide-BVH walk) on one GPU: its bound, and its time against the
plain walk and, given them, other builds of its source.

    python -m rustracer_tpu_torch.tools.bench_traverse [--other PATH ...]
        [--reps N] [--json PATH]

Builds the matte dragon (the 327,680-triangle mesh, 1024^2, 2^18-lane
tiles) and the three wavefronts of tools/traverse_work.py: 2^18 camera
rays, 2^18 bounce rays and a 2^16-lane slab with dead lanes.

On each wavefront, closest and any hit, it checks the library's K1 and
each ``--other`` source bit for bit against the plain walk (hit, prim, t
bits and the counts [rows read, triangle tests]) and times them in turns
(a, b, c, c, b, a): device time from CUDA events around a loop of ``reps``
launches, and the kernel's own device time under torch.profiler. An
``--other`` source is a traverse16.cu with the library's C interface
(cuda.SIGNATURES), next to the common.cuh it includes; it is built alone
and launched with a ray counter zeroed before each launch. The tool prints
what ptxas reports for each source, one line per case and build with the
share of K1's bound, and one JSON line of everything (also written to
``--json``). Refuses to run without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import cuda
from .._build import CSRC, compile_shared
from ..accel.traverse16 import traverse16
from .timing import events_ms, kernel_ms
from .traverse_work import (LANES, RES, equal_outputs, k1_bound, k1_work,
                            wavefronts)

K1 = ("traverse16_closest", "traverse16_any")


def nvcc_command(source):
    """nvcc and the library's flags, for ``source`` beside the headers it
    includes."""
    return [cuda.nvcc_path(), *cuda.NVCC_FLAGS,
            "-I" + os.path.dirname(os.path.abspath(source))]


def ptxas_report(source):
    """What ptxas says of the kernels in ``source`` (-Xptxas -v)."""
    cmd = [a for a in nvcc_command(source) if a != "-shared"]
    proc = subprocess.run(cmd + ["-Xptxas", "-v", "-c", source, "-o",
                                 os.devnull], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return [ln.strip() for ln in proc.stderr.splitlines()
            if "Compiling" in ln or "Used" in ln or "stack frame" in ln]


def build(others):
    """Build the library and each other source, and ask ptxas of each, all
    at once -> ({name: loaded other build, or None for the library},
    {name: ptxas lines})."""
    sources = {"library": os.path.join(CSRC, "traverse16.cu")}
    sources.update((p, os.path.abspath(p)) for p in others)
    with concurrent.futures.ThreadPoolExecutor(2 * len(sources)) as pool:
        lib = pool.submit(cuda.library)
        libs = {name: pool.submit(compile_shared, f"k1_other{i}", [src],
                                  nvcc_command(src))
                for i, (name, src) in enumerate(sources.items()) if i}
        reports = {name: pool.submit(ptxas_report, src)
                   for name, src in sources.items()}
        lib.result()
        builds = {"library": None}
        builds.update((name, cuda.load(f.result(), K1))
                      for name, f in libs.items())
        return builds, {name: f.result() for name, f in reports.items()}


def k1_call(lib, geom, ray, any_hit, with_counts):
    """One K1 launch -> (hit, t, prim, counts or None): the library's
    through its wrapper, or ``lib``'s with the same arguments and a ray
    counter zeroed before the launch."""
    if lib is None:
        out = traverse16(geom, ray.o, ray.d, ray.t_max, any_hit=any_hit,
                         with_counts=with_counts)
        return out if with_counts else (*out, None)
    n, dev = ray.o.shape[0], ray.o.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev) \
        if with_counts else None
    table = geom.bvh16_table
    cuda.launch(K1[any_hit], table, table.shape[0], geom.bvh16_roots,
                geom.bvh16_depth, ray.o, ray.d, ray.t_max, n, hit, t, prim,
                counts, torch.zeros(1, dtype=torch.int32, device=dev),
                lib=lib)
    return hit, t, prim, counts


def measure(geom, waves, builds, reps=20, log=print):
    """Check and time every build on every case -> list of row dicts."""
    rows = []
    names = list(builds)
    for label, ray in waves.items():
        for any_hit in (False, True):
            ref, work = k1_work(geom, ray, any_hit)
            bound_ms, bound_by = k1_bound(work)
            case = f"{label} {'any' if any_hit else 'closest'}"
            runs = {}
            for name, lib in builds.items():
                out = k1_call(lib, geom, ray, any_hit, True)
                torch.cuda.synchronize()
                if not equal_outputs(out, ref):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"walk on {case}")
                runs[name] = lambda lib=lib: k1_call(lib, geom, ray, any_hit,
                                                     False)
            ev = {name: [] for name in names}
            prof = {name: [] for name in names}
            for name in names + names[::-1]:      # a, b, c, c, b, a
                ev[name].append(events_ms(runs[name], reps))
                prof[name].append(kernel_ms(runs[name], reps,
                                            "traverse16_kernel"))
            for name in names:
                ms = float(np.mean(prof[name]))
                row = dict(case=case, build=name, events_ms=ev[name],
                           profiler_ms=prof[name], bound_ms=bound_ms,
                           bound_by=bound_by, bound_share=bound_ms / ms,
                           rays_per_s=work["rays"] / (ms * 1e-3), **work)
                rows.append(row)
                log(f"{case:15s} {name} events "
                    f"{'/'.join(f'{x:.4f}' for x in ev[name])} ms, "
                    f"profiler {'/'.join(f'{x:.4f}' for x in prof[name])} "
                    f"ms, {row['rays_per_s'] / 1e9:.3f} G rays/s, bound "
                    f"{bound_ms:.4f} ms ({bound_by}), "
                    f"{100 * row['bound_share']:.2f}% of it")
            log(f"{case:15s} work: {work}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another traverse16.cu to time (repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_traverse: no CUDA device; nothing runs on the "
                         "CPU")
    from ..render.renderer import RenderConfig, Renderer
    from ..scenes import build_dragon_matte

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    builds, reports = build(args.other)
    for name, lines in reports.items():
        for ln in lines:
            print(f"ptxas [{name}] {ln}", flush=True)
    dev = torch.device("cuda:0")
    ctx, cam, film, sampler, integ, n_tris = build_dragon_matte(
        res=RES, device=dev)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=LANES),
                 device=dev)
    waves = wavefronts(ctx, cam, sampler, r.tiles)
    print(f"dragon: {n_tris} triangles, {ctx.geom.bvh16_table.shape[0]} "
          f"records, depth {ctx.geom.bvh16_depth}", flush=True)
    rows = measure(ctx.geom, waves, builds, args.reps,
                   log=lambda s: print(s, flush=True))
    out = dict(card=card, ptxas=reports, rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
