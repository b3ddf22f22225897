"""K5 (the atlas EWA lookup) and K6 (the alive-first order) on the inputs of
one full-width textured step, against their plain versions and, given them,
other builds of their sources.

    python -m rustracer_tpu_torch.tools.bench_step_kernels [--other PATH ...]
        [--reps N] [--json PATH]

Builds the textured headline dragon (1024^2, the 64-spp config, 2^18-lane
tiles, compaction on) and runs one step of tile 2 (all floor and dragon,
sample 1), recording the inputs of every call of K5 (one for bounce 0 and
one for each interior bounce: four), of K6 (the alive mask after bounce 0)
and of K8 (the material rows) in that step (``capture_step``).

K5 runs on each recorded call in both texel layouts (the quad rows the
render uses, and the (T, 3) texels): the library's kernel within the plain
version's tolerance (lanes beyond 1e-5 at most 1e-3, zeros where reg < 0),
every ``--other`` build bit for bit equal to the library's. K6 runs on the
recorded mask: every build bit-equal with the plain version (the stable
argsort, its rank and the count). Each build is timed in turns (a, b, c, c,
b, a): the device time of its kernels under torch.profiler, by name
(tools/timing.py kernel_ms), and the time of a call with the host ahead
of the device (queued_ms: for K6 it holds the gaps between its launches). The tool prints the share of
textured lanes of each K5 input, K5's bound (tools/atlas_work.py) and K6's
(its flags in, order and rank out), what ptxas reports for each source
(-Xptxas -v), one line per case and build, and one JSON line of everything
(also written to ``--json``).

An ``--other`` source is an atlas.cu or compact.cu with the library's C
interface (cuda.SIGNATURES), next to the common.cuh it includes; it is
built alone, and what it exports decides which kernel it is timed as. A
compact.cu's K6 is given zeroed scratch words enough for either the
one-launch kernel's status words or a three-launch kernel's chunk counts.
Refuses to run without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import cuda
from .._build import CSRC, compile_shared
from ..ops import compact as C
from ..scene import atlas as A
from ..scene import materials as M
from .atlas_work import k5_bound, k5_work
from .bench_traverse import nvcc_command, ptxas_report
from .timing import kernel_ms, queued_ms
from .traverse_work import PEAK_BYTES_PER_S

K5, K6 = "atlas_lookup_ewa", "alive_first_order"
# the device kernels of each: K6's one launch, or the count, scan and place
# launches of a three-launch build
K5_KERNELS = ("atlas_ewa_kernel",)
K6_KERNELS = ("alive_first_kernel", "count_kernel", "scan_counts_kernel",
              "place_kernel")
LANES = 1 << 18
RES = (1024, 1024)
STEP_TILE = 2
SI_FIELDS = ("uv", "dudx", "dvdx", "dudy", "dvdy")


@contextlib.contextmanager
def _recording(module, name, calls):
    """Within the scope, calls of ``module.name`` append their arguments
    to ``calls`` before running as usual."""
    orig = getattr(module, name)

    def recorded(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_step(renderer, ctx, tile, sample=1):
    """One step of ``tile`` at ``sample`` -> dict of the inputs of its K5,
    K6 and K8 calls, in call order: k5 [dict(texels, meta, levels, regs,
    reg, si, quad)], k6 [alive], k8 [(table, idx)] (the material rows)."""
    k5, k6, k8 = [], [], []
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with _recording(A, K5, k5), _recording(C, K6, k6), \
            _recording(M, "row_gather", k8):
        renderer.step(ctx, fs, px, py, sample, v)
    out = dict(k5=[], k6=[a[0].clone() for a, _ in k6],
               k8=[(a[0], a[1].clone()) for a, _ in k8])
    for (texels, meta, levels, regs, reg, si), kw in k5:
        out["k5"].append(dict(
            texels=texels, meta=meta, levels=levels, regs=regs,
            reg=reg.clone(), quad=kw.get("quad", False),
            si=SimpleNamespace(**{f: getattr(si, f).clone()
                                  for f in SI_FIELDS})))
    return out


def k5_call(lib, case, texels, quad):
    """One K5 call on a recorded input: the library's through its wrapper,
    or ``lib``'s with the same arguments."""
    c, si = case, case["si"]
    if lib is None:
        return A.atlas_lookup_ewa(texels, c["meta"], c["levels"], c["regs"],
                                  c["reg"], si, quad=quad)
    n = c["reg"].shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=texels.device)
    r = c["regs"]
    cuda.launch(K5, texels, int(quad), c["meta"], c["meta"].shape[1],
                c["levels"], r["reg_img"], r["reg_map"], r["reg_scale"],
                r["reg_wrap"], c["reg"], si.uv, si.dudx, si.dvdx, si.dudy,
                si.dvdy, n, *A.TAP_WEIGHTS32, A.WSUM32, out, lib=lib)
    return out


def k6_scratch(n, device):
    """Zeroed scratch words for another build's K6: enough for the status
    words of the one-launch kernel and for the chunk counts of a
    three-launch one (1024 lanes a chunk)."""
    words = max(-(-n // C.K6_TILE_LANES) + 1, -(-n // 1024))
    return torch.zeros(words, dtype=torch.int32, device=device)


def k6_call(lib, alive, scratch):
    """One K6 call: the library's through its wrapper, or ``lib``'s on
    ``scratch`` (k6_scratch)."""
    if lib is None:
        return C.alive_first_order(alive)
    n = alive.shape[0]
    order = torch.empty(n, dtype=torch.int32, device=alive.device)
    rank = torch.empty(n, dtype=torch.int32, device=alive.device)
    n_alive = torch.empty((), dtype=torch.int32, device=alive.device)
    cuda.launch(K6, alive, n, order, rank, n_alive, scratch, lib=lib)
    return order, rank, n_alive


def build(others):
    """Build the library and each other source, and ask ptxas of the
    library's atlas.cu and compact.cu and of each other source, all at
    once -> ({kernel: {build name: loaded build, or None for the
    library}}, {source name: ptxas lines})."""
    sources = {"library atlas.cu": os.path.join(CSRC, "atlas.cu"),
               "library compact.cu": os.path.join(CSRC, "compact.cu")}
    sources.update((p, os.path.abspath(p)) for p in others)
    with concurrent.futures.ThreadPoolExecutor(2 * len(sources)) as pool:
        lib = pool.submit(cuda.library)
        libs = {p: pool.submit(compile_shared, f"step_other{i}",
                               [os.path.abspath(p)], nvcc_command(p))
                for i, p in enumerate(others)}
        reports = {name: pool.submit(ptxas_report, src)
                   for name, src in sources.items()}
        lib.result()
        builds = {K5: {"library": None}, K6: {"library": None}}
        for p, f in libs.items():
            exports = [k for k in (K5, K6)
                       if hasattr(ctypes.CDLL(f.result()), "rt_" + k)]
            if not exports:
                raise ValueError(f"{p} exports neither rt_{K5} nor rt_{K6}")
            loaded = cuda.load(f.result(), exports)
            for k in exports:
                builds[k][p] = loaded
        return builds, {name: f.result() for name, f in reports.items()}


def _turns(runs, reps, names):
    """Time each build in turns (a, b, ..., ..., b, a) -> {build:
    (kernel ms list, queued ms list)}: the device time of its kernels
    named in ``names`` (timing.kernel_ms), and of a call with the host
    ahead (timing.queued_ms)."""
    order = list(runs)
    prof = {b: [] for b in order}
    queued = {b: [] for b in order}
    for b in order + order[::-1]:
        prof[b].append(kernel_ms(runs[b], reps, names))
        queued[b].append(queued_ms(runs[b], reps))
    return {b: (prof[b], queued[b]) for b in order}


def _row(case, build, timed, bound_ms, bound_by, **extra):
    ms = float(np.mean(timed[0]))
    return dict(case=case, build=build, profiler_ms=timed[0],
                queued_ms=timed[1], ms=ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms, **extra)


def _log_row(log, r):
    log(f"{r['case']:24s} {r['build']}: profiler "
        f"{'/'.join(f'{x:.4f}' for x in r['profiler_ms'])} ms, queued "
        f"{'/'.join(f'{x:.4f}' for x in r['queued_ms'])} ms; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"{100 * r['bound_share']:.2f}% of it")


def measure_k5(ctx, cap, builds, reps=20, log=print):
    """Check and time every K5 build on every recorded call, both
    layouts -> list of row dicts."""
    flat = A.atlas_texels(ctx.textures["images"]).to(cap["k5"][0]["reg"]
                                                     .device)
    rows = []
    for li, case in enumerate(cap["k5"]):
        reg = case["reg"]
        share = (reg >= 0).float().mean().item()
        for quad, texels in ((True, case["texels"]), (False, flat)):
            label = f"K5 call {li} {'quad' if quad else 'texels'}"
            work = k5_work(case["meta"], case["levels"], case["regs"], reg,
                           case["si"], quad)
            bound_ms, bound_by = k5_bound(work)
            out = k5_call(None, case, texels, quad)
            with cuda.plain_reference():
                ref = k5_call(None, case, texels, quad)
            d = (out - ref).abs().max(-1).values
            off = (d > 1e-5).float().mean().item()
            if off > 1e-3 or bool(out[reg < 0].any()):
                raise AssertionError(f"{label}: the kernel differs from the "
                                     "plain version")
            for b, lib in builds.items():
                o = k5_call(lib, case, texels, quad)
                if not torch.equal(o.view(torch.int32),
                                   out.view(torch.int32)):
                    raise AssertionError(f"{label}: {b} differs in bits from "
                                         "the library's kernel")
            log(f"{label}: {reg.shape[0]} lanes, {share:.4f} textured; "
                f"max abs err {d.max().item():.3g}, lanes beyond 1e-5 "
                f"{off:.3g}; every build bit-equal; work {work}")
            timed = _turns({b: (lambda lib=lib: k5_call(lib, case, texels,
                                                        quad))
                            for b, lib in builds.items()}, reps,
                           K5_KERNELS)
            for b in builds:
                r = _row(label, b, timed[b], bound_ms, bound_by,
                         textured_share=share, max_abs_err=d.max().item(),
                         **work)
                rows.append(r)
                _log_row(log, r)
    return rows


def k6_moved(alive):
    """Bytes K6 must move: the flags in, order and rank out."""
    return alive.shape[0] * (1 + 4 + 4)


def measure_k6(cap, builds, reps=20, log=print):
    """Check and time every K6 build on the recorded mask, three calls in
    a row each -> list of row dicts."""
    alive = cap["k6"][0]
    with cuda.plain_reference():
        ref = C.alive_first_order(alive)
    scratch = {b: k6_scratch(alive.shape[0], alive.device) for b in builds}
    for b, lib in builds.items():
        for _ in range(3):
            out = k6_call(lib, alive, scratch[b])
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                raise AssertionError(f"K6 {b} differs from the plain sort")
    bound_s = k6_moved(alive) / PEAK_BYTES_PER_S
    n_alive = int(ref[2].item())
    log(f"K6: {alive.shape[0]} lanes, {n_alive} alive; every build "
        "bit-equal with the stable argsort, rank and count, three calls "
        "in a row")
    timed = _turns({b: (lambda lib=lib, s=scratch[b]: k6_call(lib, alive, s))
                    for b, lib in builds.items()}, reps, K6_KERNELS)
    rows = []
    for b in builds:
        r = _row("K6 step mask", b, timed[b], bound_s * 1e3, "bytes",
                 lanes=alive.shape[0], n_alive=n_alive)
        rows.append(r)
        _log_row(log, r)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another atlas.cu or compact.cu to time "
                         "(repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_step_kernels: no CUDA device; nothing runs "
                         "on the CPU")
    from ..render.renderer import RenderConfig, Renderer
    from ..scenes import build_dragon

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
    ctx, cam, film, sampler, integ, _ = build_dragon(res=RES, device=dev)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=LANES),
                 device=dev)
    cap = capture_step(r, ctx, r.tiles[STEP_TILE])
    print(f"step of tile {STEP_TILE}: {len(cap['k5'])} K5 calls, "
          f"{len(cap['k6'])} K6 call", flush=True)
    log = lambda s: print(s, flush=True)   # noqa: E731
    rows = measure_k5(ctx, cap, builds[K5], args.reps, log) \
        + measure_k6(cap, builds[K6], args.reps, log)
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
