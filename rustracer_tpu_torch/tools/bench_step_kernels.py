"""K2 (the interaction rebuild), K4 (the film splat, also with the
triangle, Gaussian and Mitchell filters: K4F), K5 (the atlas EWA lookup), K6 (the alive-first order), K7
(the slab take and put), K9 with those filters (the splat's backward:
K9F), K10 (the lookup's backward) and K11 (the row gather's backward) on
the inputs of full-width textured steps, K12 (the light grid's
contribution sums) over whole grids, K17 (the per-texture mipmap
lookups) and K19 (the Fourier BSDF) on full-width steps of the texture
scenes, and K20 (K17's texel gradient) on a recorded textures-train
backward, against their plain versions and, given them, other builds of
their sources.

    python -m rustracer_tpu_torch.tools.bench_step_kernels [--other PATH ...]
        [--time-only PATH ...] [--reps N]
        [--kernels K2,K4,K5,K6,K7,K10,K11,K17,K19,K20,K12,K4F,K9F]
        [--k12-corners] [--json PATH]

Builds the textured headline dragon (1024^2, the 64-spp config, 2^18-lane
tiles, compaction on) and runs one step of tile 2 (all floor and dragon,
sample 1), recording the inputs of every call of K4 (the step's splat), K5
(one for bounce 0 and one for each interior bounce: four), K6 (the alive
mask after bounce 0) and K8 (the material rows) in that step
(``capture_step``); then one step of tile 0 (mostly sky, so it takes a
slab), recording K7's fields as bounce 0 left them, its order and width.

K2 runs on the closest hits of the dragon's camera and bounce wavefronts
(tools/traverse_work.py: triangle lanes and misses), of 2^18 rays at
the 16-quadric table over a ground triangle (tools/quadric_work.py:
quadric and triangle lanes), of a full-width testball-matte step's camera
rays, of a testball-glass step's bounce 1 (the call with the most hits
leaving the ball from inside) and of the instanced gallery's camera rays
(``k2_step_cases``); every build's 15 outputs bit for bit with the
library's, timed in turns (``k2_runs``: the library through its wrapper
and launched directly, with and without the wrapper's zero fills), then
each case with its lanes sorted by kind on the host (``k2_sorted``),
bounded by tools/quadric_work.py k2_bound; the SASS of each other build's
kernels against the library's, instruction for instruction
(``compare_k2_sass``). A ``--time-only`` interaction.cu (a diagnostic
build: tools/k2_parts.py) is timed on the K2 cases unchecked.

K4 runs on the recorded splat into a zero 1024^2 film, bit for bit equal
with the plain version (box 0.5: a pixel takes at most two taps), and is
timed with L2 evicted before each call, as the render's one splat a step
finds it (timing.cold_ms). K7 runs take and put on the recorded slab, bit
for bit, timed warm, as in the render, where bounce 0 has just written
the fields.

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
(also written to ``--json``). For film.cu and compact.cu it also prints
the memory instructions of each kernel in program order, from cuobjdump's
SASS (``sass_memory_ops``): K4's reductions a tap, K7's loads and stores.

An ``--other`` source is an interaction.cu, film.cu, film_bwd.cu,
atlas.cu, compact.cu, atlas_bwd.cu, gather_bwd.cu or lightdistrib.cu with
the library's C interface (cuda.SIGNATURES), next to the headers it
includes (common.cuh, filter.cuh, quadrics.cuh); it is built alone, and
what it exports decides which kernels it is timed as:
``rt_build_interaction`` K2, ``rt_film_add_samples`` K4, ``rt_film_add_samples_bwd`` K9,
``rt_atlas_lookup_ewa`` K5, ``rt_alive_first_order`` K6, ``rt_slab_take``
K7 (take and put), ``rt_atlas_lookup_ewa_bwd`` K10, ``rt_row_gather_bwd``
K11, ``rt_spatial_grid_contrib`` K12. An interaction.cu from before K2's
quadric branch exports ``rt_build_interaction_tri`` (K2_TRI_ARGS) and is
timed on the triangle cases only. A
film.cu that exports ``rt_film_channels`` takes the film as one (H, W, 4)
buffer, as the library's does; one that does not (an older source) is
given its own (H, W, 3) and (H, W) sums, compared after packing. A
compact.cu's K6 is given zeroed scratch words enough for either the
one-launch kernel's status words or a three-launch kernel's chunk counts.
K10 and K11 run on the recorded backward pass of tile 2's step
(``capture_grad_step``): K10 on each of its calls (the texel gradient
within 1e-5 of the plain result's largest entry, for every build), with
its global atomics counted on the host (tools/atlas_work.py
k10_atomics); K11 on each of its calls (each entry within 1e-4 of its sum
of magnitudes), both timed in turns. An atlas_bwd.cu needs atlas.cuh and
common.cuh beside it; a gather_bwd.cu that does not export
``rt_row_gather_bwd_blocks`` (the parent's) is called with the parent's
arguments, into a zeroed output. K4F runs the splat of tile 2's step
rendered with a radius-2 filter (``filtered_splat``), its film's filter
swapped for each of FILTERS (PBRT's defaults), in the step's order (a
warp's lanes are consecutive pixels of a row: K4's warp-summed path) and
permuted (its per-tap path), every build within 1e-5 relative
of the plain splat, timed with L2 evicted, bounded by its bytes and its
operations (``k4_ops``; the per-tap design's count printed beside). K12 fills
the parsed Cornell box's grid and the dragon scene file's (over
build_dragon's tables, which the file reproduces), every build within
1e-5 relative (1e-6 of the largest sum) of the plain version; with
``--k12-corners`` each ``--other`` lightdistrib.cu has the per-chunk C
interface (K12_CORNER_ARGS: voxel corners, not the grid) and is launched
once a CHUNK_VOXELS chunk, its kernel time the sum of its launches. K9F
runs K9 with each of FILTERS on the backward of tile 2's step rendered
with that filter (``filtered_grad_step``: the film's gradient of the
step's loss, its samples and radiance), the triangle's every build bit
for bit with the plain gather, the Gaussian's and Mitchell's within 1e-5
relative (1e-6 absolute; the plain version's exp and divides by a number
round differently on the card), timed warm in turns, as the train step
finds the film's gradient (written just before), bounded by ``k9_moved``
and ``k9_ops``; a film_bwd.cu that does not export
``rt_film_bwd_layout`` (an older source) is called without the sample
layout's two arguments. A ``--time-only`` film_bwd.cu (a diagnostic
build that computes a wrong gradient on purpose: tools/k9_parts.py) is
timed on the K9F calls beside the others, unchecked.

K17 and K19 run on one step of tile 2 of tools/texture_work.py's
textures-image and testball-fourier at 1024^2 (their 8-sample configs,
``capture_shading``): K17 on every recorded call, each logged with its
mode, wrap and texel layout (the exact calls with their box taps a lane
and a warp), K19 on every recorded call and on the three modes over 2^18
seeded lanes of a wide table (``WIDE_TABLE``: 64 knots, orders up to 64,
above the kernel's register path); every build
held against the plain version on every call (tools/texture_work.py
compare_with_plain), the first call of each mode (K17: each mode and
wrap) timed in turns, bounded by k17_work and k19_work (K19 by its
recurrence count, the per-term count beside). An ``--other`` mipmap.cu
(exporting ``rt_mipmap_lookup``) needs mipmap.cuh, atlas.cuh and
common.cuh beside it, a fourier.cu (``rt_fourier_bsdf``) common.cuh; a
``--time-only`` mipmap.cu (tools/k17_parts.py) is timed on the K17 calls
unchecked.

K20 runs on every call of the backward of textures-train at 256^2, its
images 1024^2, recorded after three train steps as chip_smoke's phase 22
records it (``capture_k20``): each call's texture, wrap, lanes (and
those with a nonzero gradient), texels, adds and global atomics (the
parent's design and this one's, tools/texture_work.py k20_atomics)
logged; every build and route (``k20_runs``: each threads a lookup
forced) held against the plain version on every call
(compare_bwd_with_plain), every call timed in turns, bounded by
k20_work. An ``--other`` mipmap_bwd.cu needs mipmap.cuh, atlas.cuh,
texel_grad.cuh and common.cuh beside it; one whose
``rt_mipmap_lookup_bwd`` takes no ``group`` (an older source) runs with
its own choice only; a ``--time-only`` one (tools/k20_parts.py) is timed
unchecked.

K15 and K16 run on every infinite_sample and infinite_escape call of one
full-width bathroom step (and K16 on envmap-dof's camera rays), K12's
lights kernel (K12L) on the bathroom's grid, on each light of
tools/light_work.py's MIXED_SCENE alone over the mixed scene's grid, and
on the Cornell box's triangle table beside K12 (``light_step_cases``);
K16's and K12L's calls are timed as the sum of their launches, each
build's launches a call logged. An ``--other`` lights.cu or
lightdistrib.cu needs lights.cuh, quadrics.cuh and common.cuh beside it;
a ``--time-only`` one (tools/k15_parts.py, k16_parts.py,
k12l_parts.py) is timed unchecked.
``--kernels`` picks what is measured (all by default); the dragon is
built only for the kernels that need it.

Refuses to run without CUDA.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from .. import cuda
from ..accel.traverse16 import traverse16
from .._build import CSRC, compile_shared
from ..ops import compact as C
from ..ops import fourier as FO
from ..ops import gather as G
from ..ops import mipmap as MM
from ..render.film import Film
from ..scene import atlas as A
from ..scene import materials as M
from ..scene.tables import QUADRIC_KEYS, build_interaction, closest_prim
from . import quadric_work as QW
from . import texture_work as TW
from .atlas_work import k10_atomics, k10_work, k5_bound, k5_work
from .bench_traverse import nvcc_command, ptxas_report
from .timing import cold_ms, events_ms, kernel_ms, queued_ms, short_name
from .traverse_work import PEAK_BYTES_PER_S, PEAK_OPS_PER_S, wavefronts

K4, K5, K6, K7 = ("film_add_samples", "atlas_lookup_ewa", "alive_first_order",
                  "slab_take")
K9, K10, K11 = ("film_add_samples_bwd", "atlas_lookup_ewa_bwd",
                "row_gather_bwd")
K12 = "spatial_grid_contrib"
K2 = "build_interaction"
K17, K19, K20 = "mipmap_lookup", "fourier_bsdf", "mipmap_lookup_bwd"
K4D = "film_add_samples_det"
K15, K16, K12L = ("infinite_sample", "infinite_escape",
                  "spatial_grid_contrib_lights")
# K2's C interface before its quadric branch (rt_build_interaction_tri):
# t_shade, n_tris, nq, the rays and hits, n, the 15 outputs, stream
K2_TRI_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 16
K2_FIELDS = ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
             "dndu", "dndv", "wo", "material", "arealight", "prim_id")
# K4's arguments in a film.cu without the filter kinds (no
# rt_film_filter_kinds export): the box only
K4_BOX_ARGS = (cuda.SIGNATURES[K4][:15] + cuda.SIGNATURES[K4][-1:])
# K9's arguments in a film_bwd.cu without the sample layout (no
# rt_film_bwd_layout export)
K9_NO_LAYOUT_ARGS = cuda.SIGNATURES[K9][:-3] + cuda.SIGNATURES[K9][-1:]
KERNELS = {"K2": K2, "K4": K4, "K5": K5, "K6": K6, "K7": K7, "K10": K10, "K11": K11,
           "K17": K17, "K19": K19, "K20": K20,
           "K12": K12, "K4F": K4, "K9F": K9, "K4d": K4D, "K15": K15,
           "K16": K16, "K12L": K12L}
# the device kernels of each: K6's one launch, or the count, scan and place
# launches of a three-launch build
K2_KERNELS = ("build_interaction_kernel",)
K4_KERNELS = ("film_add_kernel",)
K5_KERNELS = ("atlas_ewa_kernel",)
K6_KERNELS = ("alive_first_kernel", "count_kernel", "scan_counts_kernel",
              "place_kernel")
K7_KERNELS = ("slab_kernel",)
K9_KERNELS = ("film_add_bwd_kernel",)
K10_KERNELS = ("atlas_ewa_bwd_kernel",)
K11_KERNELS = ("row_gather_bwd_kernel", "row_gather_bwd_shared_kernel")
K12_KERNELS = ("grid_contrib_kernel",)
K17_KERNELS = ("mipmap_kernel",)
K19_KERNELS = ("fourier_kernel",)
K20_KERNELS = ("mipmap_bwd_",)
# K4d's tiled kernel and its per-pixel kernel (wide footprints; the
# design before the tiles)
K4D_KERNELS = ("film_add_det",)
K15_KERNELS = ("infinite_sample_kernel",)
K16_KERNELS = ("infinite_escape_kernel",)
# K12's lights kernel: its branches' instantiations, and K12's kernel on
# a run of triangle lights
K12L_KERNELS = ("grid_contrib_lights_kernel", "grid_contrib_kernel")
# K15's, K16's and K12's lights kernel's recorded step: the bathroom with
# its film at BATH_RES, one sample, 2^18-lane tiles, tile BATH_TILE (and
# K16's camera rays on envmap-dof at RES, tile 0): chip_smoke phase 19's
BATH_RES, BATH_TILE = (1920, 1080), 2
# K12's lights kernel on each branch: case -> the light of
# tools/light_work.py's MIXED_SCENE that it computes alone (light_scene),
# over the mixed scene's grid (chip_smoke phase 19's K12_BRANCHES)
K12_BRANCH_CASES = {
    "point": "point", "distant": "distant",
    "sphere (cone)": "full sphere (cone)", "clipped sphere": "clipped sphere",
    "disk": "disk", "cylinder": "cylinder", "triangle": "triangle",
    "sky": "infinite"}
# the scenes whose recorded step (tile STEP_TILE, SHADING_SAMPLES samples'
# config) K17 and K19 run on, and the wide Fourier table's lanes
K17_SCENE, K19_SCENE = "textures-image", "testball-fourier"
SHADING_SAMPLES = 8
WIDE_LANES = 1 << 18
WIDE_TABLE = dict(n_mu=64, m_max=64)
# K20's recorded backward: textures-train's film, the side of its two
# images, the learning rate and the train steps before it (chip_smoke
# phase 22's)
K20_RES, K20_IMAGE, K20_LR, K20_STEPS = 256, 1024, 1.0, 3
# K2's recorded steps: the testballs' camera and glass bounce-1 hits, and
# the gallery's camera hits (its film, chip_smoke phase 21's)
K2_BALLS = ("matte", "glass")
GALLERY_RES = (1024, 768)
# K12's per-chunk C interface, before it took the grid (--k12-corners):
# voxel corners (n, 3), n, the voxel extent, halton, n_probes, the light
# tables, n_lights, out, stream; called once a CHUNK_VOXELS chunk
K12_CORNER_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# the filters of the full-width splat (K4F), PBRT's defaults: radius 2
FILTERS = ("triangle", "gaussian", "mitchell")
# operations of K4 with a filter other than the box, counted from
# csrc/film.cu and csrc/filter.cuh (32-bit float operations, compares,
# selects and conversions at one instruction each, exp and the divide as
# one each). A sample evaluates each axis's weights once, nx + ny 1-D
# weights: the offset (a conversion, 2 adds or subtracts) and the extent
# test (abs, compare) 5 for every kind, then the triangle's subtract and
# max 2, the Gaussian's 2 multiplies, exp, subtract and max 5, Mitchell's
# divide, 2x and its abs, x^2, x^3, the inner piece 5, the outer 7, 2
# compares and 2 selects 21. A tap: the weight's product and its mask's
# select 2, then 4 multiplies into the float4.
FILTER_AXIS_OPS = {"triangle": 7, "gaussian": 10, "mitchell": 26}
K4F_TAP_OPS = 6
# the per-tap design's count, a tap evaluating both 1-D weights again:
# the offsets and the extent test 11, the triangle's two weights and their
# product 7, the Gaussian's 11, Mitchell's 43, then K4's 4 multiplies
K4F_TAP_OPS_PER_TAP = {"triangle": 22, "gaussian": 26, "mitchell": 58}
# K9's operations: each axis's weights once a sample (FILTER_AXIS_OPS),
# then a tap's product, its mask's select, 3 multiplies and 3 adds; with
# the luminance clamp on, its VJP a sample (csrc/film_bwd.cu): the
# luminance 5, the compare and the floor 2, the scale (divide, multiply,
# select) 3, the dot product 5, d_lum (a compare, an and, 2 multiplies,
# a divide, a negation, a select) 7 and the 3 outputs' multiplies,
# multiplies and adds 9
K9_TAP_OPS = 8
K9_CLAMP_OPS = 31
# K20's C interface before its threads a lookup: the arguments without
# ``group``
K20_PARENT_ARGS = cuda.SIGNATURES[K20][:-2] + cuda.SIGNATURES[K20][-1:]
# K20's threads a lookup timed beside each block's own choice, by mode:
# every route it has (csrc/mipmap_bwd.cu has_route)
K20_GROUPS = {"trilinear": (1, 2), "ewa": (4, 8), "exact": (1, 2, 4, 8)}
# K11's C interface before its register path: g, idx, n, rows,
# width, out (zeroed, added into), stream
K11_PARENT_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] * 2
LANES = 1 << 18
RES = (1024, 1024)
STEP_TILE = 2
SLAB_TILE = 0


def _cloned(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_cloned(a) for a in x)
    return x


@contextlib.contextmanager
def _recording(module, name, calls, copy=False):
    """Within the scope, calls of ``module.name`` append their arguments
    (with ``copy``, clones of their tensors, as they were when called) to
    ``calls`` before running as usual."""
    orig = getattr(module, name)

    def recorded(*args, **kw):
        calls.append(_cloned((args, kw)) if copy else (args, kw))
        return orig(*args, **kw)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_step(renderer, ctx, tile, sample=1):
    """One step of ``tile`` at ``sample`` -> dict of the inputs of its K4,
    K5, K6, K7 and K8 calls, in call order: k4 [dict(film, p_film,
    radiance, valid)], k5 [dict(texels, meta, levels, regs, reg, si,
    quad)], k6 [alive], k7 [dict(fields, order, w)] (the slab takes: the
    fields as bounce 0 left them), k8 [(table, idx)] (the material rows)."""
    k4, k5, k6, k7, k8 = [], [], [], [], []
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with _recording(Film, "add_samples", k4), _recording(A, K5, k5), \
            _recording(C, K6, k6), _recording(C, K7, k7, copy=True), \
            _recording(M, "row_gather", k8):
        renderer.step(ctx, fs, px, py, sample, v)
    k4 = [inspect.signature(Film.add_samples).bind(*a, **kw).arguments
          for a, kw in k4]
    out = dict(k4=[dict(film=c["self"], p_film=c["p_film"].clone(),
                        radiance=c["radiance"].clone(),
                        valid=_cloned(c.get("valid"))) for c in k4],
               k5=[], k6=[a[0].clone() for a, _ in k6],
               k7=[dict(fields=a[0], order=a[1], w=a[2]) for a, _ in k7],
               k8=[(a[0], a[1].clone()) for a, _ in k8])
    for (texels, meta, levels, regs, reg, si), kw in k5:
        out["k5"].append(dict(
            texels=texels, meta=meta, levels=levels, regs=regs,
            reg=reg.clone(), quad=kw.get("quad", False),
            si=SimpleNamespace(**{f: getattr(si, f).clone()
                                  for f in A.SI_FIELDS})))
    return out


def capture_grad_step(renderer, ctx, tile, sample=1):
    """The backward pass of one step of ``tile`` at ``sample`` with every
    float leaf of ``ctx.textures`` requiring grad (the loss: the mean
    square of the step's image) -> dict of the inputs of its backward
    kernels' calls, in call order, as (args, kwargs) with tensors cloned:
    k9 (Film.add_samples_bwd: film, g_acc, p_film, radiance, valid), k10
    (atlas_lookup_ewa_bwd: g, texels, meta, levels, regs, reg, si,
    quad_index), k11 (row_gather_bwd: g, idx, rows), take_t
    (compact.take_transpose: order, w, g_subs, shapes) and put_t
    (compact.put_transpose: order, w, g_full)."""
    from ..parallel.mesh import float_leaves
    leaves, rebuild = float_leaves(ctx.textures)
    theta = [p.detach().requires_grad_() for p in leaves]
    c = dataclasses.replace(ctx, textures=rebuild(theta))
    px, py, v = tile
    with torch.enable_grad():
        fs = renderer.step(c, renderer.film.init_state(renderer.device),
                           px, py, sample, v)
        loss = (renderer.film.to_image(fs) ** 2).mean()
    out = {k: [] for k in ("k9", "k10", "k11", "take_t", "put_t")}
    with _recording(Film, "add_samples_bwd", out["k9"], copy=True), \
            _recording(A, "atlas_lookup_ewa_bwd", out["k10"], copy=True), \
            _recording(G, "row_gather_bwd", out["k11"], copy=True), \
            _recording(C, "take_transpose", out["take_t"], copy=True), \
            _recording(C, "put_transpose", out["put_t"], copy=True):
        torch.autograd.grad(loss, theta, allow_unused=True)
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


def k4_call(lib, case, channels=4):
    """K4 on a recorded splat -> (call, sums): ``call()`` splats it into
    a film that starts at 0 and keeps what each call adds; ``sums()`` is
    that film as (H, W, 4). The library's kernel through its wrapper, or
    ``lib``'s with the same arguments; a build of ``channels`` 3 is given
    separate (H, W, 3) and (H, W) sums, packed by ``sums()``."""
    film, p_film, rad, valid = (case[k] for k in ("film", "p_film",
                                                  "radiance", "valid"))
    fs = film.init_state(p_film.device)
    h, w = fs.wsum.shape
    if channels == 3:
        fs = type(fs)(rgb=torch.zeros((h, w, 3), dtype=torch.float32,
                                      device=p_film.device),
                      wsum=torch.zeros((h, w), dtype=torch.float32,
                                       device=p_film.device))
    x0, y0, _, _ = film.cropped_pixel_bounds
    rx, ry = film.filter.radius
    nx, ny = film._footprint()

    def call():
        if lib is None:
            film.add_samples(fs, p_film, rad, valid=valid)
        else:
            kind = () if getattr(lib, "k4_box_only", False) else (
                film.filter.kernel_params()[0],
                *film.filter.kernel_params()[1])
            cuda.launch(K4, p_film, rad, valid, p_film.shape[0], fs.rgb,
                        fs.wsum, h, w, x0, y0, rx, ry, nx, ny,
                        film.max_sample_luminance, *kind, lib=lib)
    return call, lambda: torch.cat([fs.rgb, fs.wsum[..., None]], -1)


def k4_touched(film, p_film, valid=None):
    """The distinct film pixels that the splat's taps land on (the plain
    version's footprint, crop bounds and valid mask: Film.taps)."""
    w, h = film.cropped_resolution
    pix = [(iy.long() * w + ix.long())[ok]
           for iy, ix, _, ok in film.taps(p_film, valid, h, w)]
    return torch.unique(torch.cat(pix)).numel()


def k4_moved(film, p_film, radiance, valid=None):
    """Bytes K4 must move: every sample's position, radiance and valid flag
    in, and each pixel a tap lands on read and written once (r, g, b and
    the weight: 16 bytes)."""
    inputs = [p_film, radiance] + ([] if valid is None else [valid])
    return sum(t.numel() * t.element_size() for t in inputs) \
        + 2 * 16 * k4_touched(film, p_film, valid)


def k7_moved(fields, w):
    """Bytes one K7 move must make: the slab's w order entries in, and w
    lanes of every field read and written once."""
    lane = sum(f.element_size() * (f.numel() // f.shape[0]) for f in fields)
    return w * (4 + 2 * lane)


def k7_call(lib, case, put, slab=None):
    """One K7 move of a recorded slab -> (call, out): the take fills w-lane
    slabs from the recorded fields; the put writes ``slab`` into
    full-width fields that start at 0. ``out`` is the list written. The
    library's kernel through its wrapper, or ``lib``'s with the same
    arguments."""
    fields, order, w = case["fields"], case["order"], case["w"]
    if put:
        full, subs = [torch.zeros_like(f) for f in fields], slab
    else:
        full = fields
        subs = [torch.empty((w,) + tuple(f.shape[1:]), dtype=f.dtype,
                            device=f.device) for f in fields]
    out = full if put else subs
    name = "slab_put" if put else "slab_take"

    def call():
        if lib is not None:
            C.slab_move(name, order, w, full, subs, lib=lib)
        elif put:
            C.slab_put(full, subs, order, w)
        else:
            out[:] = C.slab_take(fields, order, w)
    return call, out


def cuobjdump_path():
    return os.path.join(os.path.dirname(cuda.nvcc_path()), "cuobjdump")


_SASS_FN = re.compile(r"Function : (\S+)")
# opcodes (before their first ".") of the loads, stores and reductions
_SASS_MEM = {"LD", "LDG", "LDS", "LDL", "ST", "STG", "STS", "STL", "RED",
             "REDG", "ATOM", "ATOMG", "ATOMS"}


def sass_memory_ops(source):
    """The memory instructions of each kernel in ``source``, in program
    order, from cuobjdump's SASS of a cubin built with the library's flags
    -> {kernel (mangled name): [opcode, ...]} (``memory_ops``)."""
    cmd = [a for a in nvcc_command(source) if a != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run(cmd + ["-cubin", "-o", cubin, source], check=True,
                       capture_output=True, text=True, timeout=600)
        sass = subprocess.run([cuobjdump_path(), "-sass", cubin],
                              check=True, capture_output=True, text=True,
                              timeout=600).stdout
    return memory_ops(sass)


def memory_ops(sass):
    """cuobjdump -sass text -> {kernel: [the opcode, with its modifiers,
    of each load, store and reduction, in program order]}."""
    ops, fn = {}, None
    for ln in sass.splitlines():
        m = _SASS_FN.search(ln)
        if m:
            fn = m.group(1)
            ops[fn] = []
        elif fn is not None and "*/" in ln:
            code = ln.split("*/", 1)[1].strip()
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", code).split(" ", 1)[0]
            if op.split(".", 1)[0] in _SASS_MEM:
                ops[fn].append(op.rstrip(";"))
    return ops


def build(others, k12_corners=False):
    """Build the library and each other source, and ask ptxas of the
    library's interaction.cu, film.cu, film_bwd.cu, atlas.cu, compact.cu, atlas_bwd.cu,
    gather_bwd.cu, lightdistrib.cu, mipmap.cu and fourier.cu and of each other source (and
    cuobjdump of each film.cu, film_bwd.cu, compact.cu, atlas_bwd.cu and
    gather_bwd.cu), all at once; ``k12_corners``: each
    other source's K12 has the per-chunk interface (K12_CORNER_ARGS) ->
    ({kernel: {build name: loaded build, or None for the library}},
    {source name: ptxas lines}, {source name: sass_memory_ops},
    {build name: film channels})."""
    sources = {f"library {f}": os.path.join(CSRC, f)
               for f in ("interaction.cu", "film.cu", "film_bwd.cu", "atlas.cu", "compact.cu",
                         "atlas_bwd.cu", "gather_bwd.cu", "lightdistrib.cu", "mipmap.cu",
                         "fourier.cu", "mipmap_bwd.cu", "lights.cu")}
    sources.update((p, os.path.abspath(p)) for p in others)
    kernels = (K2, K4, K5, K6, K7, K9, K10, K11, K12, K17, K19, K20, K4D,
               K15, K16, K12L)
    sass_of = ("film.cu", "film_bwd.cu", "compact.cu", "atlas_bwd.cu",
               "gather_bwd.cu")
    with concurrent.futures.ThreadPoolExecutor(3 * len(sources)) as pool:
        lib = pool.submit(cuda.library)
        libs = {p: pool.submit(compile_shared, f"step_other{i}",
                               [os.path.abspath(p)], nvcc_command(p))
                for i, p in enumerate(others)}
        reports = {name: pool.submit(ptxas_report, src)
                   for name, src in sources.items()}
        sass = {name: pool.submit(sass_memory_ops, src)
                for name, src in sources.items()
                if os.path.basename(src) in sass_of}
        lib.result()
        builds = {k: {"library": None} for k in kernels}
        channels = {"library": 4}
        for p, f in libs.items():
            handle = ctypes.CDLL(f.result())
            exports = [k for k in kernels if hasattr(handle, "rt_" + k)]
            k2_tri = hasattr(handle, "rt_build_interaction_tri")
            exports += [K2] if k2_tri else []
            if not exports:
                raise ValueError(f"{p} exports none of "
                                 f"{['rt_' + k for k in kernels]}")
            k11_parent = K11 in exports and not hasattr(
                handle, "rt_row_gather_bwd_blocks")
            k12_chunked = K12 in exports and k12_corners
            names = [k for k in exports if not (k == K11 and k11_parent)
                     and not (k == K12 and k12_chunked)
                     and not (k == K2 and k2_tri)]
            loaded = cuda.load(f.result(), names
                               + (["slab_put"] if K7 in exports else [])
                               + (["row_gather_bwd_blocks"]
                                  if K11 in names else [])
                               + (["build_interaction_inst"] if K2 in names
                                  and hasattr(handle,
                                              "rt_build_interaction_inst")
                                  else []))
            loaded.path = f.result()
            if K20 in names and not _k20_takes_group(p):
                fn = loaded.rt_mipmap_lookup_bwd
                fn.argtypes = K20_PARENT_ARGS
                loaded.rt_mipmap_lookup_bwd = _without_group(fn)
                loaded.k20_parent = True
            if k12_chunked:
                loaded.rt_spatial_grid_contrib.argtypes = K12_CORNER_ARGS
                loaded.rt_spatial_grid_contrib.restype = ctypes.c_int
                loaded.k12_chunked = True
            if k2_tri:
                loaded.rt_build_interaction_tri.argtypes = K2_TRI_ARGS
                loaded.rt_build_interaction_tri.restype = ctypes.c_int
                loaded.k2_tri = True
            if k11_parent:
                loaded.rt_row_gather_bwd.argtypes = K11_PARENT_ARGS
                loaded.rt_row_gather_bwd.restype = ctypes.c_int
                loaded.k11_parent = True
            for k in exports:
                builds[k][p] = loaded
            if K4 in exports:
                channels[p] = handle.rt_film_channels() \
                    if hasattr(handle, "rt_film_channels") else 3
                if not hasattr(handle, "rt_film_filter_kinds"):
                    # a film.cu from before the filter kinds (box only)
                    loaded.rt_film_add_samples.argtypes = K4_BOX_ARGS
                    loaded.k4_box_only = True
            if K9 in exports and not hasattr(handle, "rt_film_bwd_layout"):
                # a film_bwd.cu from before the sample layout's arguments
                loaded.rt_film_add_samples_bwd.argtypes = K9_NO_LAYOUT_ARGS
                loaded.k9_layout = False
        return (builds, {name: f.result() for name, f in reports.items()},
                {name: f.result() for name, f in sass.items()}, channels)


def _turns(runs, reps, names, cold=False, launches=None):
    """Time each build in turns (a, b, ..., ..., b, a) -> {build:
    (kernel ms list, queued ms list)}: the device time of its kernels
    named in ``names`` (timing.kernel_ms), and of a call with the host
    ahead (timing.queued_ms); with ``cold``, both with L2 evicted before
    each call (timing.cold_ms: by name, and between CUDA events with each
    call queued behind a sleeping kernel). With ``launches`` (a dict), a
    call's kernel time is the sum of all its launches (timing.kernel_ms
    ``per_call``) and ``launches`` receives {build: {kernel: [launches a
    call, its median ms]}}."""
    order = list(runs)
    prof = {b: [] for b in order}
    queued = {b: [] for b in order}
    for b in order + order[::-1]:
        if cold:
            prof[b].append(cold_ms(runs[b], reps, name=names))
            queued[b].append(cold_ms(runs[b], reps))
        elif launches is not None:
            seen, med = {}, {}
            prof[b].append(kernel_ms(runs[b], reps, names, True, seen, med))
            launches[b] = {k: [n, med[k]] for k, n in seen.items()}
            queued[b].append(queued_ms(runs[b], reps))
        else:
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
        f"{100 * r['bound_share']:.2f}% of it"
        + (f"; launches a call {r['launches']}" if "launches" in r else ""))


def k2_cases(ctx, cam, sampler, renderer):
    """-> {case: (geom, ray, hit, t, prim)}: the closest hits of the
    dragon's camera and bounce wavefronts and of LANES rays at the
    16-quadric table over a ground triangle."""
    waves = wavefronts(ctx, cam, sampler, renderer.tiles)
    cases = {}
    for label in ("camera", "bounce"):
        ray = waves[label]
        hit, t, tid = traverse16(ctx.geom, ray.o, ray.d, ray.t_max,
                                 any_hit=False)
        cases[f"K2 dragon {label}"] = (
            ctx.geom, ray, hit, t, torch.where(hit, tid + ctx.geom.n_quadrics,
                                               0))
    q = QW.quadric_table()
    geom = QW.table_geometry(q, device=renderer.device)
    ray = QW.quadric_rays(q, LANES, device=renderer.device)
    cases["K2 quadric table"] = (geom, ray, *closest_prim(geom, ray))
    return cases


def k2_step_cases(dev, res=RES, lanes=LANES, balls=K2_BALLS, gallery=True):
    """-> {case: (geom, ray, hit, t, prim[, inst])}: K2's recorded calls
    of one step (tile STEP_TILE, or the last tile of a smaller film) of
    testball-<ball> with its film at ``res`` for each of ``balls`` (matte: the camera
    hits; glass: the call with the most hits leaving the ball from
    inside, bounce 1, quadric_work.inside_counts) and, with ``gallery``,
    of the instanced gallery at GALLERY_RES (its camera hits, K2's
    instance branch)."""
    from ..scene.api import parse_scene_string
    from ..utils import fileutil
    from .profile_step import testball_text
    cases = {}
    for ball in balls:
        text, scenes = testball_text(f"testball-{ball}", res)
        fileutil.set_search_directory(scenes)
        bundle = parse_scene_string(text, device=dev).scene
        r, ctx = bundle.renderer(lanes), bundle.context()
        tile = r.tiles[min(STEP_TILE, len(r.tiles) - 1)]
        calls = QW.capture_quadric_step(r, ctx, tile, every=True)
        k2 = calls["build_interaction"]
        i = 0
        if ball == "glass":
            counts = QW.inside_counts(k2, "build_interaction")
            i = int(np.argmax(counts))
        cases[f"K2 testball-{ball} call {i}"] = k2[i]
    if gallery:
        from ..render.renderer import RenderConfig, Renderer
        from ..scenes import build_instanced
        from . import geometry_work as GW
        ctx, cam, film, sampler, integ = build_instanced(res=GALLERY_RES,
                                                         device=dev)
        r = Renderer(integ.li, cam, film, sampler,
                     RenderConfig(max_lanes=lanes), device=dev)
        args, kw = GW.capture_geometry_step(
            r, ctx, r.tiles[STEP_TILE])["build_interaction"][0]
        cases["K2 gallery camera"] = tuple(args[:5]) + (
            args[5] if len(args) > 5 else kw["inst"],)
    return cases


def k2_sorted(case):
    """``case`` with its lanes sorted by kind (miss, triangle, then each
    quadric type: one path a warp but at the kinds' edges) -> (the sorted
    case, the order: sorted lane j is lane order[j])."""
    geom, ray, hit, t, prim = case[:5]
    nq = geom.n_quadrics
    qt = geom.q_type[prim.clamp(0, nq - 1).long()]
    quad = (prim < nq) & bool(geom.has_quadrics)
    kind = torch.where(~hit, 0, torch.where(quad, 2 + qt, 1))
    order = torch.argsort(kind, stable=True)
    ray = type(ray)(o=ray.o[order].contiguous(), d=ray.d[order].contiguous(),
                    t_max=ray.t_max[order].contiguous())
    rest = tuple(x[order].contiguous() for x in (hit, t, prim) + case[5:])
    return (geom, ray) + rest, order


def k2_call(lib, case, fills=False):
    """One K2 call on a case -> its outputs in K2_FIELDS order: the
    library's through its wrapper (``lib`` None), or ``lib``'s with the
    same arguments (one from before the quadric branch through its
    triangle entry), and with ``fills`` the two zero fills of the
    wrapper's Interaction (its texture differentials) after it; a case
    with instances through the instance entry."""
    geom, ray, hit, t, prim = case[:5]
    inst = case[5:]
    if lib is None:
        si = build_interaction(geom, ray, hit, t, prim, *inst)
        return [getattr(si, f) for f in K2_FIELDS]
    n, dev = t.shape[0], t.device
    out = [torch.empty((n, 2 if f == "uv" else 3), dtype=torch.float32,
                       device=dev) for f in K2_FIELDS[:12]] \
        + [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    rays = (ray.o, ray.d, ray.t_max, hit, t, prim, n)
    if getattr(lib, "k2_tri", False):
        cuda.launch(K2 + "_tri", geom.t_shade, geom.n_triangles,
                    geom.n_quadrics, *rays, *out, lib=lib)
    elif inst:
        cuda.launch(K2 + "_inst", geom.t_shade, geom.n_triangles,
                    geom.n_quadrics, int(geom.has_quadrics),
                    *(getattr(geom, k) for k in QUADRIC_KEYS), *rays, *out,
                    inst[0], geom.inst_o2w, geom.inst_w2o, geom.inst_flip,
                    lib=lib)
    else:
        cuda.launch(K2, geom.t_shade, geom.n_triangles, geom.n_quadrics,
                    int(geom.has_quadrics),
                    *(getattr(geom, k) for k in QUADRIC_KEYS), *rays, *out,
                    lib=lib)
    if fills:
        torch.zeros_like(t), torch.zeros_like(out[0])
    return out


def _k2_takes(lib, case):
    """Whether build ``lib`` (None: the library) runs ``case``: one from
    before the quadric branch the triangle-only cases, one without the
    instance entry none with instances."""
    geom = case[0]
    if getattr(lib, "k2_tri", False):
        return not geom.has_quadrics and len(case) == 5
    return len(case) == 5 or lib is None or hasattr(
        lib, "rt_build_interaction_inst")


def k2_runs(builds, case):
    """-> {run name: (build, fills)} of ``case``: each build that takes
    it, and the library also launched as the other builds are ("library
    direct"), with and without the wrapper's two zero fills after each
    call (k2_call ``fills``: the gap between the wrapper's timing and the
    same kernel's)."""
    runs = {b: (lib, False) for b, lib in builds.items()
            if _k2_takes(lib, case)}
    if "library direct" in runs:
        runs["library direct (the wrapper's zero fills)"] = (
            runs["library direct"][0], True)
    return runs


def measure_k2(cases, builds, reps=20, log=print, unchecked=()):
    """Check and time every K2 build on each case it takes (k2_runs):
    every output bit for bit with the library's (builds in ``unchecked``:
    tools/k2_parts.py's, unchecked), timed in turns; then each case with
    its lanes sorted by kind (k2_sorted: one path a warp, for the
    measurement only), the other checked builds again bit for bit with
    the library's on the case as recorded and timed in turns."""
    rows = []
    for case, args in cases.items():
        geom, _, hit, _, prim = args[:5]
        runs = k2_runs(builds, args)
        ref = k2_call(None, args)
        sorted_args, order = k2_sorted(args)
        sorted_runs = {b: r for b, r in runs.items()
                       if b not in unchecked and r[0] is not None
                       and not r[1]}
        for label, a, rs in (("", args, runs),
                             (" sorted", sorted_args, sorted_runs)):
            for b, (lib, fills) in rs.items():
                if b in unchecked:
                    continue
                out = k2_call(lib, a, fills)
                for f, x, y in zip(K2_FIELDS, out, ref):
                    if label:
                        x = torch.empty_like(x).index_copy_(0, order, x)
                    if not torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)):
                        raise AssertionError(f"{case}{label} {b}: {f} "
                                             "differs from the library's")
        bound_ms, bound_by, n_q, n_t = QW.k2_bound(geom, hit, prim)
        n_inst = int((args[5] >= 0).sum()) if len(args) > 5 else 0
        log(f"{case}: {n_q} quadric, {n_t} triangle ({n_inst} instanced) "
            f"lanes of {hit.shape[0]}; every checked build bit for bit with "
            "the library, also on the lanes sorted by kind")
        for label, a, rs in (("", args, runs),
                             (" sorted", sorted_args, sorted_runs)):
            timed = _turns({b: (lambda r=r, a=a: k2_call(r[0], a, r[1]))
                            for b, r in rs.items()}, reps, K2_KERNELS)
            for b in rs:
                r = _row(case + label, b, timed[b], bound_ms, bound_by,
                         quadric_lanes=n_q, triangle_lanes=n_t,
                         instanced_lanes=n_inst, checked=b not in unchecked)
                rows.append(r)
                _log_row(log, r)
    return rows


def function_sass(path):
    """cuobjdump's SASS of each kernel in the shared library or cubin at
    ``path`` -> {kernel (mangled name): [instruction text without its
    address and encoding]}."""
    sass = subprocess.run([cuobjdump_path(), "-sass", path], check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = _SASS_FN.search(ln)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn is not None and "*/" in ln and ln.strip().startswith("/*"):
            out[fn].append(ln.split("*/", 1)[1].split("/*")[0].strip())
    return out


def compare_k2_sass(builds, log=print):
    """For each other K2 build, whether its kernels' SASS is the
    library's, instruction for instruction -> {build: {kernel: (same,
    instructions in the library's, in the build's)}}."""
    lib_fns = {k: v for k, v in function_sass(cuda.library_path()).items()
               if "build_interaction_kernel" in k}
    out = {}
    for b, lib in builds.items():
        if not hasattr(lib, "path") or getattr(lib, "k2_tri", False):
            continue
        fns = function_sass(lib.path)
        out[b] = {k: (fns.get(k) == v, len(v), len(fns.get(k, [])))
                  for k, v in lib_fns.items()}
        for k, (same, n_lib, n_b) in out[b].items():
            log(f"K2 SASS {b}: {k}: {'the same as' if same else 'differs from'}"
                f" the library's ({n_b} instructions against {n_lib})")
    return out


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


def measure_k4(cap, builds, channels, reps=20, log=print):
    """Check every K4 build on the step's recorded splat, bit for bit
    with the plain version, and time them with L2 evicted before each
    call -> list of row dicts."""
    case = cap["k4"][0]
    with cuda.plain_reference():
        call, sums = k4_call(None, case)
        call()
        ref = sums()
    for b, lib in builds.items():
        call, sums = k4_call(lib, case, channels[b])
        call()
        if not torch.equal(sums().view(torch.int32), ref.view(torch.int32)):
            d = (sums() - ref).abs().max().item()
            raise AssertionError(f"K4 {b} differs in bits from the plain "
                                 f"splat (max abs {d:.3g})")
    film, p_film = case["film"], case["p_film"]
    moved = k4_moved(film, p_film, case["radiance"], case["valid"])
    touched = k4_touched(film, p_film, case["valid"])
    log(f"K4: {p_film.shape[0]} samples onto {touched} pixels of the "
        f"{tuple(ref.shape)} film, box {film.filter.radius}; every build "
        "bit-equal with the plain splat")
    timed = _turns({b: k4_call(lib, case, channels[b])[0]
                    for b, lib in builds.items()}, reps, K4_KERNELS,
                   cold=True)
    rows = []
    for b in builds:
        r = _row("K4 step splat, L2 cold", b, timed[b],
                 moved / PEAK_BYTES_PER_S * 1e3, "bytes",
                 samples=p_film.shape[0], touched=touched, bytes=moved)
        rows.append(r)
        _log_row(log, r)
    return rows


def measure_k7(cap, builds, reps=20, log=print):
    """Check every K7 build's take and put on the recorded slab, bit for
    bit with the plain versions, and time them warm -> list of row
    dicts."""
    case = cap["k7"][0]
    fields, w = case["fields"], case["w"]
    with cuda.plain_reference():
        call, ref_take = k7_call(None, case, False)
        call()
        call, ref_put = k7_call(None, case, True, ref_take)
        call()
    runs = {}
    for b, lib in builds.items():
        take, subs = k7_call(lib, case, False)
        take()
        put, full = k7_call(lib, case, True, ref_take)
        put()
        for label, out, ref in (("take", subs, ref_take),
                                ("put", full, ref_put)):
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                raise AssertionError(f"K7 {b} {label} differs from the "
                                     "plain version")
        runs[b] = (take, put)
    moved = k7_moved(fields, w)
    log(f"K7: {len(fields)} fields, {fields[0].shape[0]} lanes, a {w}-lane "
        "slab; every build bit-equal with the plain take and put")
    rows = []
    for k, label in enumerate(("take", "put")):
        timed = _turns({b: runs[b][k] for b in builds}, reps, K7_KERNELS)
        for b in builds:
            r = _row(f"K7 slab_{label}", b, timed[b],
                     moved / PEAK_BYTES_PER_S * 1e3, "bytes",
                     lanes=fields[0].shape[0], w=w, bytes=moved)
            rows.append(r)
            _log_row(log, r)
    return rows


def k10_call(lib, case):
    """One K10 call on a recorded input (the arguments of
    atlas_lookup_ewa_bwd): the library's through its wrapper, or ``lib``'s
    with the same arguments into a zeroed gradient."""
    (g, texels, meta, levels, regs, reg, si, qidx), _ = case
    if lib is None:
        return A.atlas_lookup_ewa_bwd(g, texels, meta, levels, regs, reg, si,
                                      qidx)
    out = torch.zeros_like(texels)
    cuda.launch(K10, g, int(qidx is not None), meta, meta.shape[1], levels,
                regs["reg_img"], regs["reg_map"], regs["reg_scale"],
                regs["reg_wrap"], reg, si.uv, si.dudx, si.dvdx, si.dudy,
                si.dvdy, reg.shape[0], *A.TAP_WEIGHTS32, A.WSUM32, out,
                texels.shape[0], lib=lib)
    return out


def measure_k10(grad, builds, reps=20, log=print):
    """Check and time every K10 build on every recorded call of the
    backward step -> list of row dicts."""
    rows = []
    for i, case in enumerate(grad["k10"]):
        (g, texels, meta, levels, regs, reg, si, qidx), _ = case
        with cuda.plain_reference():
            ref = k10_call(None, case)
        top = ref.abs().max().item()
        errs = {}
        for b, lib in builds.items():
            d = (k10_call(lib, case) - ref).abs().max().item()
            if not d <= 1e-5 * top:
                raise AssertionError(f"K10 call {i} {b}: max abs err {d:.3g}"
                                     f" beyond 1e-5 of {top:.3g}")
            errs[b] = d
        work = k10_work(meta, levels, regs, reg, si, texels.shape[0])
        bound_ms, bound_by = k5_bound(work)
        atomics = k10_atomics(meta, levels, regs, reg, si, qidx is not None,
                              g, texels.shape[0])
        log(f"K10 call {i}: {reg.shape[0]} lanes, {work['textured']} "
            f"textured, {texels.shape[0]} texels; max abs err {errs} of "
            f"max {top:.3g}; global atomics {atomics}")
        timed = _turns({b: (lambda lib=lib: k10_call(lib, case))
                        for b, lib in builds.items()}, reps, K10_KERNELS)
        for b in builds:
            r = _row(f"K10 call {i}", b, timed[b], bound_ms, bound_by,
                     max_abs_err=errs[b], atomics=atomics, **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def k11_call(lib, case):
    """One K11 call on a recorded input (g, idx, rows): the library's
    through its wrapper, or ``lib``'s with the same arguments (a parent
    build's into a zeroed output)."""
    (g, idx, n_rows), _ = case
    if lib is None:
        return G.row_gather_bwd(g, idx, n_rows)
    n, width = g.shape
    if getattr(lib, "k11_parent", False):
        out = torch.zeros((n_rows, width), dtype=torch.float32,
                          device=g.device)
        cuda.launch(K11, g, idx, n, n_rows, width, out, lib=lib)
        return out
    blocks = cuda.host_call("row_gather_bwd_blocks", n, n_rows, width,
                            lib=lib)
    out = torch.empty((n_rows, width), dtype=torch.float32, device=g.device)
    partials = torch.empty(blocks * n_rows * width, dtype=torch.float32,
                           device=g.device)
    cuda.launch(K11, g, idx, n, n_rows, width, out, partials,
                G._k11_counter(g.device), lib=lib)
    return out


def measure_k11(grad, builds, reps=20, log=print):
    """Check and time every K11 build on every recorded call of the
    backward step -> list of row dicts."""
    rows = []
    for i, case in enumerate(grad["k11"]):
        (g, idx, n_rows), _ = case
        with cuda.plain_reference():
            ref = k11_call(None, case)
            ref_abs = G.row_gather_bwd(g.abs(), idx, n_rows)
        errs = {}
        for b, lib in builds.items():
            out = k11_call(lib, case)
            d = (out - ref).abs()
            of_abs = (d / ref_abs.clamp(min=1e-30)).max().item()
            if not of_abs <= 1e-4:
                raise AssertionError(f"K11 call {i} {b}: {of_abs:.3g} of an "
                                     "entry's sum of magnitudes")
            same = torch.equal(out.view(torch.int32),
                               k11_call(lib, case).view(torch.int32))
            errs[b] = (d.max().item(), of_abs, same)
        moved = sum(t.numel() * t.element_size() for t in (g, idx, ref))
        log(f"K11 call {i}: {g.shape[0]} x {g.shape[1]} into {n_rows} rows; "
            f"(max abs err, of the sum of magnitudes, two launches "
            f"bit-equal) {errs}")
        timed = _turns({b: (lambda lib=lib: k11_call(lib, case))
                        for b, lib in builds.items()}, reps, K11_KERNELS)
        for b in builds:
            r = _row(f"K11 call {i}", b, timed[b],
                     moved / PEAK_BYTES_PER_S * 1e3, "bytes",
                     max_abs_err=errs[b][0], reproducible=errs[b][2],
                     bytes=moved)
            rows.append(r)
            _log_row(log, r)
    return rows


def k4_ops(film, n):
    """Operations K4 must do for ``n`` samples with ``film``'s filter (not
    the box): each sample's nx + ny axis weights, then its nx * ny taps
    (FILTER_AXIS_OPS, K4F_TAP_OPS)."""
    nx, ny = film._footprint()
    kind = film.filter.kind
    return n * ((nx + ny) * FILTER_AXIS_OPS[kind] + nx * ny * K4F_TAP_OPS)


def k9_ops(film, n):
    """Operations K9 must do for ``n`` samples with ``film``'s filter (not
    the box): each sample's nx + ny axis weights, its nx * ny taps
    (FILTER_AXIS_OPS, K9_TAP_OPS) and, with the luminance clamp on, the
    clamp's VJP (K9_CLAMP_OPS)."""
    nx, ny = film._footprint()
    clamp = K9_CLAMP_OPS if np.isfinite(film.max_sample_luminance) else 0
    return n * ((nx + ny) * FILTER_AXIS_OPS[film.filter.kind]
                + nx * ny * K9_TAP_OPS + clamp)


def k9_moved(film, p_film, radiance, valid=None):
    """Bytes K9 must move: every sample's position and valid flag in and
    its radiance gradient out; the radiance in only where the luminance
    clamp is on (its VJP reads it); each pixel a tap lands on read once
    (r, g, b and the weight's gradient: 16 bytes)."""
    inputs = [p_film] + ([] if valid is None else [valid])
    if np.isfinite(film.max_sample_luminance):
        inputs.append(radiance)
    return sum(t.numel() * t.element_size() for t in inputs) \
        + 12 * p_film.shape[0] + 16 * k4_touched(film, p_film, valid)


def k9_call(lib, case):
    """One K9 call on a recorded input (Film.add_samples_bwd's arguments:
    film, g_acc, p_film, radiance, valid): the library's through its
    wrapper, or ``lib``'s with the same arguments."""
    (film, g_acc, p_film, rad, valid), _ = case
    if lib is None:
        return film.add_samples_bwd(g_acc, p_film, rad, valid)
    n = p_film.shape[0]
    h, w = g_acc.shape[:2]
    x0, y0, _, _ = film.cropped_pixel_bounds
    rx, ry = film.filter.radius
    nx, ny = film._footprint()
    kind, fp = film.filter.kernel_params()
    sx0, _, sx1, _ = film.get_sample_bounds()
    layout = (sx1 - sx0, sx0) if getattr(lib, "k9_layout", True) else ()
    out = torch.empty((n, 3), dtype=torch.float32, device=p_film.device)
    cuda.launch(K9, p_film, rad, valid, n, g_acc, h, w, x0, y0, rx, ry, nx,
                ny, film.max_sample_luminance, kind, *fp, out, *layout,
                lib=lib)
    return out


def check_k9(out, ref, kind, label):
    """K9 against the plain gather: the triangle's bit for bit, the
    Gaussian's and Mitchell's within 1e-5 relative, 1e-6 absolute (the
    plain version's exp and divides by a number round differently on the
    card) -> the largest absolute difference."""
    d = (out - ref).abs().max().item()
    same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
    if not (same if kind == "triangle"
            else torch.allclose(out, ref, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"{label} differs from the plain gather (max "
                             f"abs {d:.3g})")
    return d


def measure_k9f(grads, builds, reps=20, log=print, unchecked=()):
    """K9 with the triangle, Gaussian and Mitchell filters on the recorded
    backward of a step rendered with each (``grads[kind]``,
    ``filtered_grad_step``), every build but those named in ``unchecked``
    checked (``check_k9``) and timed warm in turns -> list of row
    dicts."""
    rows = []
    for kind in FILTERS:
        case = grads[kind]
        (film, g_acc, p_film, rad, valid), _ = case
        n = p_film.shape[0]
        nx, ny = film._footprint()
        moved = k9_moved(film, p_film, rad, valid)
        ops = k9_ops(film, n)
        t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        label = f"K9F {kind}"
        with cuda.plain_reference():
            ref = k9_call(None, case)
        errs = {b: None if b in unchecked else check_k9(
            k9_call(lib, case), ref, kind, f"{label} {b}")
            for b, lib in builds.items()}
        log(f"{label}: {n} samples, {nx} x {ny} taps, onto "
            f"{k4_touched(film, p_film, valid)} pixels of a "
            f"{tuple(g_acc.shape)} gradient; max abs err {errs}; {ops} "
            f"operations ({t_ops * 1e3:.4f} ms), {moved} bytes "
            f"({t_bytes * 1e3:.4f} ms)")
        timed = _turns({b: (lambda lib=lib: k9_call(lib, case))
                        for b, lib in builds.items()}, reps, K9_KERNELS)
        for b in builds:
            r = _row(f"{label}, warm", b, timed[b], bound_ms, bound_by,
                     samples=n, bytes=moved, operations=ops,
                     max_abs_err=errs[b])
            rows.append(r)
            _log_row(log, r)
    return rows


def with_filter(case, kind):
    """A recorded K4 call (capture_step's k4 entry) with its film's filter
    swapped for ``kind`` at PBRT's default radius 2 and parameters."""
    from ..render.filters import make_filter
    return dict(case, film=dataclasses.replace(case["film"],
                                               filter=make_filter(kind)))


def filtered(renderer, kind):
    """``renderer`` with its film's filter swapped for ``kind`` at PBRT's
    radius 2: its tiles cover that film's sample bounds, row-major, as a
    renderer of any radius-2 filter lays them out."""
    from ..render.filters import make_filter
    from ..render.renderer import Renderer
    film = dataclasses.replace(renderer.film, filter=make_filter(kind))
    return Renderer(renderer.li_fn, renderer.camera, film, renderer.sampler,
                    renderer.config, device=renderer.device)


def filtered_splat(renderer, ctx, tile, sample=1, kind="triangle"):
    """The K4 call of one step of tile number ``tile`` of ``renderer``
    with its film's filter swapped for ``kind`` (``filtered``: that
    renderer's tile; ``with_filter`` then swaps among those filters)."""
    r = filtered(renderer, kind)
    return capture_step(r, ctx, r.tiles[tile], sample)["k4"][0]


def filtered_grad_step(renderer, ctx, tile, sample=1, kind="triangle"):
    """The K9 call of the backward of one step of tile number ``tile`` of
    ``renderer`` with its film's filter swapped for ``kind`` (``filtered``:
    that renderer's tile; ``capture_grad_step``) -> ((film, g_acc, p_film,
    radiance, valid), kwargs), tensors cloned."""
    r = filtered(renderer, kind)
    return capture_grad_step(r, ctx, r.tiles[tile], sample)["k9"][0]


def permuted(case, seed=0):
    """The same splat with its samples in a random order, so that no warp
    holds consecutive pixels of a row (K4's per-tap path)."""
    n = case["p_film"].shape[0]
    gen = torch.Generator(device=case["p_film"].device)
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=case["p_film"].device)
    return dict(case, p_film=case["p_film"][perm].contiguous(),
                radiance=case["radiance"][perm].contiguous(),
                valid=None if case["valid"] is None
                else case["valid"][perm].contiguous())


def check_k4_filtered(out, ref, label):
    """K4 with a filter against the plain splat: every entry within 1e-5
    relative, 1e-6 absolute (contended reductions, the warp sums' order)
    -> the largest absolute difference."""
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-6):
        d = (out - ref).abs().max().item()
        raise AssertionError(f"{label} differs from the plain splat (max abs "
                             f"{d:.3g})")
    return (out - ref).abs().max().item()


def measure_k4f(cap, builds, channels, reps=20, log=print):
    """K4 with the triangle, Gaussian and Mitchell filters on a step's
    recorded splat (``cap["k4f"]``, ``filtered_splat``; the film's filter
    swapped), each build in the step's order (a warp's lanes on 32
    consecutive pixels of a row: K4's warp-summed path) and permuted (its
    per-tap path), within 1e-5 relative of the plain splat, timed in turns
    with L2 evicted before each call -> list of row dicts."""
    rows = []
    for kind in FILTERS:
        base = with_filter(cap["k4f"], kind)
        film, p_film = base["film"], base["p_film"]
        n = p_film.shape[0]
        nx, ny = film._footprint()
        moved = k4_moved(film, p_film, base["radiance"], base["valid"])
        ops = k4_ops(film, n)
        t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ops_per_tap = n * nx * ny * K4F_TAP_OPS_PER_TAP[kind]
        for order, case in (("step order", base),
                            ("permuted", permuted(base))):
            label = f"K4F {kind} {order}"
            with cuda.plain_reference():
                call, sums = k4_call(None, case)
                call()
                ref = sums()
            errs = {}
            for b, lib in builds.items():
                call, sums = k4_call(lib, case, channels[b])
                call()
                errs[b] = check_k4_filtered(sums(), ref, f"{label} {b}")
            log(f"{label}: {n} samples, {nx} x {ny} taps, onto "
                f"{k4_touched(film, p_film, base['valid'])} pixels; max abs "
                f"err {errs} (within 1e-5 relative); {ops} operations "
                f"({ops / PEAK_OPS_PER_S * 1e3:.4f} ms; the per-tap count "
                f"{ops_per_tap}, {ops_per_tap / PEAK_OPS_PER_S * 1e3:.4f} ms), "
                f"{moved} bytes ({t_bytes * 1e3:.4f} ms)")
            timed = _turns({b: k4_call(lib, case, channels[b])[0]
                            for b, lib in builds.items()}, reps, K4_KERNELS,
                           cold=True)
            for b in builds:
                r = _row(f"{label}, L2 cold", b, timed[b], bound_ms, bound_by,
                         samples=n, bytes=moved, operations=ops,
                         operations_per_tap_design=ops_per_tap, max_abs_err=errs[b])
                rows.append(r)
                _log_row(log, r)
    return rows


def k12_grids(dev, dragon_ctx=None):
    """The two grids K12 fills: the parsed Cornell box's (64 x 63 x 64, 2
    lights) and the dragon scene file's (64 x 11 x 64 over build_dragon's
    tables, which the file reproduces; its 2-triangle light; given
    ``dragon_ctx``) -> [(label, lights, world_lo, vox_ext, nv)]."""
    from ..scene import lightdistrib as LD
    from ..scene.api import parse_scene
    cornell = parse_scene(os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "scenes", "cornell-box.pbrt"),
        device=dev).scene
    out = []
    grids = [("Cornell box", cornell.lights, cornell.geom)]
    if dragon_ctx is not None:
        grids.append(("dragon file", dragon_ctx.lights, dragon_ctx.geom))
    for label, lt, geom in grids:
        lo = geom.tv_p.min(0).values.cpu().numpy()
        hi = geom.tv_p.max(0).values.cpu().numpy()
        nv, _, ext = LD.voxels(lo, hi)
        out.append((label, lt, lo, ext, nv))
    return out


def k12_call(lib, lt, lo, ext, nv, halton, chunks=None):
    """K12 over a whole grid -> (V, n_lights): the library's through its
    wrapper (one launch), or ``lib``'s with the same arguments; a build of
    the per-chunk interface (``--k12-corners``) once a chunk of
    ``chunks``, its voxel corners on the card."""
    from ..scene import lightdistrib as LD
    if lib is None:
        return LD.grid_contrib(lt, lo, ext, nv, halton)
    n_l, n_s = lt.n_lights, halton.shape[0]
    v = int(np.prod(nv))
    out = torch.empty((v, n_l), dtype=torch.float32, device=halton.device)
    tables = (lt.l_tri_p, lt.l_tri_rev, lt.l_twosided, lt.l_emit, lt.l_area)
    if getattr(lib, "k12_chunked", False):
        start = 0
        for c in chunks:
            cuda.launch(K12, c, c.shape[0], *[float(x) for x in ext], halton,
                        n_s, *tables, n_l, out[start:start + c.shape[0]],
                        lib=lib)
            start += c.shape[0]
        return out
    cuda.launch(K12, *[float(x) for x in lo], *[float(x) for x in ext],
                *[int(x) for x in nv], halton, n_s, *tables, n_l, out,
                lib=lib)
    return out


def measure_k12(grids, builds, reps=20, log=print):
    """K12 over each whole grid, every build within 1e-5 relative (1e-6 of
    the largest sum) of the plain version, timed in turns: a per-chunk
    build's chunks are all its launches of a grid -> list of row dicts."""
    from ..scene import lightdistrib as LD
    rows = []
    for label, lt, lo, ext, nv in grids:
        dev = lt.l_emit.device
        halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                                 device=dev)
        v = int(np.prod(nv))
        chunks = [LD.voxel_corners(lo, ext, nv, s, min(s + LD.CHUNK_VOXELS,
                                                       v), dev)
                  for s in range(0, v, LD.CHUNK_VOXELS)]
        with cuda.plain_reference():
            ref = k12_call(None, lt, lo, ext, nv, halton)
        top = ref.abs().max().item()
        errs, launches = {}, {}
        for b, lib in builds.items():
            out = k12_call(lib, lt, lo, ext, nv, halton, chunks)
            d = (out - ref).abs()
            if bool(((d > 1e-5 * ref.abs()) & (d > 1e-6 * top)).any()):
                raise AssertionError(f"K12 {label} {b}: max abs err "
                                     f"{d.max().item():.3g} of {top:.3g}")
            errs[b] = d.max().item()
            launches[b] = len(chunks) if getattr(lib, "k12_chunked", False) \
                else 1
        probes = v * lt.n_lights * LD.N_SAMPLES
        moved = v * lt.n_lights * 4 + halton.numel() * 4 + sum(
            t.numel() * t.element_size() for t in (
                lt.l_tri_p, lt.l_tri_rev, lt.l_twosided, lt.l_emit,
                lt.l_area))
        t_ops = probes * LD.K12_PROBE_OPS / PEAK_OPS_PER_S
        bound_ms = max(t_ops, moved / PEAK_BYTES_PER_S) * 1e3
        log(f"K12 {label}: {tuple(int(x) for x in nv)} voxels x "
            f"{lt.n_lights} lights x {LD.N_SAMPLES} probes = {probes} "
            f"probes; max abs err {errs} of max {top:.3g}; launches "
            f"{launches}; bound {bound_ms:.4f} ms at {LD.K12_PROBE_OPS} "
            f"operations a probe (the per-chunk kernel's 42: "
            f"{probes * 42 / PEAK_OPS_PER_S * 1e3:.4f} ms)")
        timed = _turns({b: (lambda lib=lib: k12_call(lib, lt, lo, ext, nv,
                                                     halton, chunks))
                        for b, lib in builds.items()}, reps, K12_KERNELS)
        for b in builds:
            # kernel_ms is a launch's mean: a call is all its launches
            prof = [x * launches[b] for x in timed[b][0]]
            r = _row(f"K12 {label}, whole grid", b, (prof, timed[b][1]),
                     bound_ms, "operations", probes=probes,
                     launches=launches[b], max_abs_err=errs[b])
            rows.append(r)
            _log_row(log, r)
    return rows


K17_MODES = {"lookup_trilinear": MM.TRILINEAR, "lookup_ewa": MM.EWA,
             "lookup_ewa_exact": MM.EWA_EXACT}
K19_MODES = {"fourier_f": FO.F, "fourier_pdf": FO.PDF,
             "fourier_sample_f": FO.SAMPLE_F}


def capture_shading(dev, names):
    """One full-width step (tile STEP_TILE, sample 1) of each of
    tools/texture_work.py's scenes ``names`` at RES, parsed with its
    SHADING_SAMPLES-sample config, 2^18-lane tiles -> {name: every K17,
    K18 and K19 call's arguments by entry point (capture_texture_step)}."""
    from ..scene.api import parse_scene_string
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            text = TW.scene_text(name, res=RES[0], spp=SHADING_SAMPLES,
                                 bsdf_dir=tmp)
            bundle = parse_scene_string(text, device=dev).scene
            r, ctx = bundle.renderer(LANES), bundle.context()
            out[name] = TW.capture_texture_step(r, ctx, r.tiles[STEP_TILE])
    return out


def k17_call(lib, fname, args):
    """K17 (the library's, or ``lib``'s) on a recorded call of entry point
    ``fname`` (scene/textures.py's arguments) -> (B, C), as the entry point
    returns it."""
    mode = K17_MODES[fname]
    tx, st = args[0], args[1].contiguous()
    if mode == MM.TRILINEAR:
        out = MM._k17(tx, mode, args[3], st, width=args[2].contiguous(),
                      lib=lib)
    else:
        out = MM._k17(tx, mode, args[5], st, args[2].contiguous(),
                      args[3].contiguous(), max_anisotropy=args[4], lib=lib)
    return out[:, :tx.channels]


def k17_work_of(fname, args):
    """tools/texture_work.py k17_work of a recorded call."""
    mode = K17_MODES[fname]
    if mode == MM.TRILINEAR:
        return TW.k17_work(args[0], mode, args[3], args[1], width=args[2])
    return TW.k17_work(args[0], mode, args[5], args[1], args[2], args[3],
                       max_anisotropy=args[4])


def exact_taps(args):
    """The box taps an exact call's lanes visit (at most 128): their mean,
    quantiles and largest, and over warps of 32 consecutive lanes the mean
    of the longest lane's and of the warp's sum."""
    e = MM.ellipse(args[0], args[1], args[2], args[3], args[4])
    taps = torch.clamp(e.n_box, max=MM.N_TAPS_EXACT).float()
    warps = torch.cat([taps, taps.new_zeros((-taps.shape[0]) % 32)]).view(
        -1, 32)
    q = torch.quantile(taps, torch.tensor([0.5, 0.9, 0.99],
                                          device=taps.device)).tolist()
    return dict(mean=taps.mean().item(), p50=q[0], p90=q[1], p99=q[2],
                max=taps.max().item(),
                warp_longest=warps.max(1).values.mean().item(),
                warp_sum=warps.sum(1).mean().item())


def _bound(moved, ops):
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def measure_k17(calls, builds, reps=20, log=print, unchecked=()):
    """K17 on every recorded call of a textures-image step (``calls``:
    {entry point: [args]}): each call's mode, wrap and texel layout logged,
    the exact calls' box taps (``exact_taps``); every build but those of
    ``unchecked`` held against the plain version on every call
    (tools/texture_work.py compare_with_plain); the first call of each
    mode and wrap timed in turns (``unchecked`` builds too, unchecked) and
    bounded (k17_work) -> list of row dicts."""
    seq = [(f, a) for f in K17_MODES for a in calls.get(f, [])]
    firsts = {}
    for i, (fname, args) in enumerate(seq):
        wrap = args[-1]
        log(f"K17 call {i}: {fname}, wrap {wrap}, texel rows of "
            f"{args[0].texels.shape[1]} floats, {args[1].shape[0]} lanes"
            + (f", taps {exact_taps(args)}" if fname == "lookup_ewa_exact"
               else ""))
        firsts.setdefault((fname, wrap), i)
    errs = {}
    for b, lib in builds.items():
        if b in unchecked:
            continue
        worst, flipped = 0.0, 0
        for fname, args in seq:
            r = TW.compare_with_plain(fname, args, k17_call(lib, fname, args))
            worst, flipped = max(worst, r["max_abs_err"]), flipped + r["flipped"]
        errs[b] = worst
        log(f"K17 {b}: {len(seq)} calls held to the plain version, max abs "
            f"err {worst:.3g}, {flipped} flipped lanes held at the other "
            "level")
    rows = []
    for (fname, wrap), i in firsts.items():
        args = seq[i][1]
        work = k17_work_of(fname, args)
        bound_ms, bound_by = _bound(work["moved"], work["ops"])
        label = f"K17 {fname} wrap {wrap}"
        with cuda.plain_reference():
            plain = events_ms(lambda: TW._entry(fname)(*args), 5)
        timed = _turns({b: (lambda lib=lib: k17_call(lib, fname, args))
                        for b, lib in builds.items()}, reps, K17_KERNELS)
        log(f"{label} (call {i}): {work}; plain {plain:.4f} ms")
        for b in builds:
            r = _row(label, b, timed[b], bound_ms, bound_by, call=i,
                     plain_ms=plain, max_abs_err=errs.get(b),
                     checked=b not in unchecked, **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def k19_call(lib, fname, args):
    """K19 (the library's, or ``lib``'s) on a call of entry point
    ``fname`` (ts, tid, wo, wi or u, mask) -> its outputs, as the entry
    point returns them."""
    ts, tid, wo, second, mask = args
    mode = K19_MODES[fname]
    f, pdf, wi = FO._k19(mode, ts, FO._prep(ts, tid, mask), wo.contiguous(),
                         second.contiguous(), mask, lib=lib)
    return {FO.F: f, FO.PDF: pdf, FO.SAMPLE_F: (wi, f, pdf)}[mode]


def wide_fourier_calls(dev, n=WIDE_LANES, seed=11):
    """The three K19 modes on ``n`` seeded lanes of one table at a measured
    table's scale (tools/texture_work.py fourier_table(**WIDE_TABLE): 64
    knots, orders up to 64) -> [(entry point, args)]."""
    ts = FO.make_table_set([TW.fourier_table(**WIDE_TABLE)]).to(dev)
    rs = np.random.RandomState(seed)

    def dirs():
        v = rs.normal(size=(n, 3))
        return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True))
                                .astype(np.float32)).to(dev)
    tid = torch.zeros(n, dtype=torch.int32, device=dev)
    wo, wi = dirs(), dirs()
    u = torch.from_numpy(rs.uniform(size=(n, 2)).astype(np.float32)).to(dev)
    return [("fourier_f", (ts, tid, wo, wi, None)),
            ("fourier_pdf", (ts, tid, wo, wi, None)),
            ("fourier_sample_f", (ts, tid, wo, u, None))]


def measure_k19(calls, wide, builds, reps=20, log=print):
    """K19 on every recorded call of a testball-fourier step (``calls``:
    {entry point: [args]}) and on ``wide`` (wide_fourier_calls): every
    build held against the plain version on every call (compare_with_plain),
    the first step call of each mode and each wide call timed in turns and
    bounded by k19_work's recurrence count (its per-term count beside) ->
    list of row dicts."""
    seq = [("step", f, a) for f in K19_MODES for a in calls.get(f, [])]
    seq += [("wide", f, a) for f, a in wide]
    errs = {}
    for b, lib in builds.items():
        worst, flipped = 0.0, 0
        for case, fname, args in seq:
            r = TW.compare_with_plain(fname, args, k19_call(lib, fname, args))
            worst, flipped = max(worst, r["max_abs_err"]), flipped + r["flipped"]
        errs[b] = worst
        log(f"K19 {b}: {len(seq)} calls held to the plain version, max abs "
            f"err {worst:.3g}, {flipped} lanes sampled another direction, "
            "each held at its own")
    rows, seen = [], set()
    for case, fname, args in seq:
        if (case, fname) in seen:
            continue
        seen.add((case, fname))
        ts, tid, wo, second, mask = args
        work = TW.k19_work(ts, K19_MODES[fname], tid, wo, second, mask)
        bound_ms, bound_by = _bound(work["moved"], work["ops"])
        direct_ms, _ = _bound(work["moved"], work["ops_direct"])
        label = f"K19 {fname} {case} (m_pad {ts.m_pad}, {ts.n_mu} knots)"
        with cuda.plain_reference():
            plain = events_ms(lambda: TW._entry(fname)(*args), 5)
        timed = _turns({b: (lambda lib=lib: k19_call(lib, fname, args))
                        for b, lib in builds.items()}, reps, K19_KERNELS)
        log(f"{label}: {work}; bound by the per-term count "
            f"{direct_ms:.4f} ms; plain {plain:.4f} ms")
        for b in builds:
            r = _row(label, b, timed[b], bound_ms, bound_by,
                     bound_direct_ms=direct_ms, plain_ms=plain,
                     max_abs_err=errs[b], **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def capture_k20(dev, res=K20_RES, image=K20_IMAGE, lanes=LANES, lr=K20_LR,
                steps=K20_STEPS):
    """textures-train at res^2, its images image^2 (tools/texture_work.py),
    through make_train_step as chip_smoke's phase 22 runs it: ``steps``
    train steps at samples 0, 1, ..., then the step at sample ``steps``
    recorded -> {mode name: [args of each of its backward's K20 calls, in
    the order the backward makes them]} (texture_work.count_bwd_calls)."""
    from ..parallel.mesh import make_train_step
    from ..render.renderer import RenderConfig
    from ..scene.api import parse_scene_string
    with tempfile.TemporaryDirectory() as tmp:
        text = TW.scene_text("textures-train", res=res, spp=1, bsdf_dir=tmp,
                             image_size=image)
        bundle = parse_scene_string(text, device=dev).scene
    ctx = bundle.context()
    target = torch.full((res, res, 3), 0.2, device=dev)
    step = make_train_step(bundle.integrator.li, bundle.camera, bundle.film,
                           bundle.sampler, lr=lr,
                           config=RenderConfig(max_lanes=lanes), device=dev)
    for s in range(steps):
        ctx, _ = step(ctx, target, s)
    rec = {}
    with TW.count_bwd_calls({}, rec):
        step(ctx, target, steps)
    return rec


def _k20_takes_group(path):
    """Whether the mipmap_bwd.cu at ``path`` exports K20 with its threads
    a lookup (``group``); a source from before the argument does not."""
    with open(path) as f:
        m = re.search(r"rt_mipmap_lookup_bwd\(([^)]*)\)", f.read())
    return bool(m) and "int group" in m.group(1)


def _without_group(fn):
    """K20's entry ``fn`` of a build without ``group`` (K20_PARENT_ARGS),
    called with the library's arguments: each block's choice (group 0),
    the only one it has."""
    def call(*args):
        if args[-2] != 0:
            raise ValueError("this K20 build has no threads a lookup to "
                             "force")
        return fn(*args[:-2], args[-1])
    return call


def k20_call(lib, args, group=0):
    """K20 (the library's, or ``lib``'s) on a recorded call (g, tx, mode,
    wrap, st, dst0, dst1, width, max_anisotropy), ``group`` threads a
    lookup (0: each block's choice) -> the texel gradient."""
    g, tx, mode, wrap, st, dst0, dst1, width, ma = args
    g, st, dst0, dst1, width = MM._contig(g, st, dst0, dst1, width)
    return MM._k20(g, tx, mode, wrap, st, dst0, dst1, width, ma, lib=lib,
                   group=group)


def texture_of(tx):
    """A K20 call's texture, named by its pyramid's place in the texel
    rows: its first texel, level 0's size and its levels."""
    off, w, h = tx.meta[0].tolist()
    return f"texels {off}+, {w}x{h}, {tx.meta.shape[0]} levels"


def k20_runs(builds, mode_name, unchecked=()):
    """-> {run name: (build, threads a lookup)}: each build with each
    block's choice (0), and each build that takes the argument but the
    diagnostic ones of ``unchecked`` with each of K20_GROUPS[mode_name]."""
    runs = {}
    for b, lib in builds.items():
        runs[b] = (lib, 0)
        if not getattr(lib, "k20_parent", False) and b not in unchecked:
            runs.update((f"{b} G={G}", (lib, G))
                        for G in K20_GROUPS[mode_name])
    return runs


def measure_k20(calls, builds, reps=20, log=print, unchecked=()):
    """K20 on every call of a recorded textures-train backward (``calls``:
    capture_k20): each call's texture, wrap, lanes (and those with a
    nonzero gradient), texels, adds and global atomics logged
    (texture_work.k20_work, k20_atomics); every build but those of
    ``unchecked`` (tools/k20_parts.py's), with the kernel's choice of
    threads a lookup and with each of K20_GROUPS (k20_runs), held against
    the plain version on every call (texture_work.compare_bwd_with_plain);
    every call timed in turns and bounded, the first of each mode beside
    its plain version's time -> list of row dicts."""
    seq = [(name, a) for name in TW.BWD_MODES.values()
           for a in calls.get(name, [])]
    works = []
    for i, (name, args) in enumerate(seq):
        work = TW.k20_work(*args)
        atomics = TW.k20_atomics(*args)
        nonzero = int((args[0] != 0).any(1).sum())
        works.append(dict(work, nonzero_lanes=nonzero,
                          **{f"atomics_{k}": v for k, v in atomics.items()}))
        log(f"K20 call {i}: {name}, {texture_of(args[1])}, wrap {args[3]}, "
            f"{work['lanes']} lanes ({nonzero} with a nonzero gradient, "
            f"{work['active']} that add: {work['texels']} texel rows, "
            f"{work['adds']} adds); global atomics "
            f"{atomics}")
    errs = {}
    for name, args in seq:
        for run, (lib, group) in k20_runs(builds, name, unchecked).items():
            if run in unchecked:
                continue
            r = TW.compare_bwd_with_plain(*args, k20_call(lib, args, group))
            errs[run] = max(errs.get(run, 0.0), r["max_abs_err"])
    for run, err in errs.items():
        log(f"K20 {run}: {len(seq)} calls held to the plain version, max "
            f"abs err {err:.3g}")
    rows, seen = [], set()
    for i, (name, args) in enumerate(seq):
        work = works[i]
        bound_ms, bound_by = _bound(work["moved"], work["ops"])
        label = f"K20 {name} call {i}"
        plain = None
        if name not in seen:
            seen.add(name)
            with cuda.plain_reference():
                plain = events_ms(lambda: MM.mipmap_lookup_bwd(*args), 3)
        runs = k20_runs(builds, name, unchecked)
        timed = _turns({run: (lambda lib=lib, group=group:
                              k20_call(lib, args, group))
                        for run, (lib, group) in runs.items()}, reps,
                       K20_KERNELS)
        log(f"{label} ({texture_of(args[1])}, wrap {args[3]}): {work}"
            + (f"; plain {plain:.4f} ms" if plain is not None else ""))
        for run in runs:
            r = _row(label, run, timed[run], bound_ms, bound_by, call=i,
                     mode=name, texture=texture_of(args[1]), wrap=args[3],
                     plain_ms=plain, max_abs_err=errs.get(run),
                     checked=run in errs, **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def res_usage(source):
    """cuobjdump -res-usage of a cubin of ``source`` built with the
    library's flags -> {kernel (mangled name): its resource line
    (registers, stack, shared, local, ...)}."""
    cmd = [a for a in nvcc_command(source) if a != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run(cmd + ["-cubin", "-o", cubin, source], check=True,
                       capture_output=True, text=True, timeout=600)
        text = subprocess.run([cuobjdump_path(), "-res-usage", cubin],
                              check=True, capture_output=True, text=True,
                              timeout=600).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function (\S+):", ln)
        if m:
            fn = m.group(1)
        elif fn is not None and "REG:" in ln:
            out[fn] = ln.strip()
            fn = None
    return out


def k4d_cases(renderer, ctx, dev):
    """K4d's recorded splats -> {case: dict(film, p_film, radiance, valid,
    first)}: tile STEP_TILE of ``renderer``'s step with each of FILTERS
    (``filtered_splat``: one splat, the film's filter swapped; the lanes
    from STEP_TILE * LANES), and the whole splat of one step of the
    Cornell box parsed with PixelFilter mitchell (its 68^2 sample bounds in
    one tile, 1 sample), each held to the renderer's lane layout."""
    from ..scene.api import parse_scene_string
    base = filtered_splat(renderer, ctx, STEP_TILE, kind="mitchell")
    cases = {f"{kind} full width": dict(with_filter(base, kind),
                                        first=STEP_TILE * LANES)
             for kind in FILTERS}
    with open(os.path.join(os.path.dirname(CSRC), os.pardir, "scenes",
                           "cornell-box.pbrt")) as f:
        text = f.read().replace("WorldBegin", 'PixelFilter "mitchell"\n'
                                "WorldBegin", 1)
    bundle = parse_scene_string(text, device=dev).scene
    r = bundle.renderer()
    c = capture_step(r, bundle.context(), r.tiles[0], sample=0)["k4"][0]
    cases["mitchell Cornell"] = dict(c, first=0)
    for case in cases.values():
        case["film"].check_det_layout(case["p_film"], case["valid"],
                                      case["first"])
    return cases


def k4d_call(lib, case, state=None):
    """K4d (the library's, or ``lib``'s) on a recorded splat into
    ``state`` (a zero film's, by default) -> the state."""
    film = case["film"]
    if state is None:
        state = film.init_state(case["p_film"].device)
    return film._add_samples_det(state, case["p_film"], case["radiance"],
                                 case["valid"], case["first"], lib=lib)


def measure_k4d(cases, builds, reps=20, log=print, unchecked=()):
    """K4d on each recorded splat (``k4d_cases``): every build but those
    of ``unchecked`` bit for bit with the plain version
    (Film.add_samples_det_plain; for the Gaussian, whose plain exp rounds
    apart from expf, with the library's, itself within 1e-5 relative of
    the plain version) and over two launches; timed in turns
    with L2 evicted before each call, as the checkpointed render's one
    splat a step finds it, bounded as K4 (``k4_moved``) -> list of row
    dicts."""
    rows = []
    for label, case in cases.items():
        film, p_film = case["film"], case["p_film"]
        rad, valid, first = case["radiance"], case["valid"], case["first"]
        dev = p_film.device
        with cuda.plain_reference():
            ref = film.add_samples_det_plain(film.init_state(dev), p_film,
                                             rad, valid, first)
        gauss = film.filter.kind == "gaussian"
        if gauss:
            # the plain version's exp rounds apart from expf on the card:
            # the library within 1e-5 relative of it, every build bit for
            # bit with the library
            lib_out = k4d_call(None, case)
            torch.testing.assert_close(lib_out.rgb, ref.rgb, rtol=1e-5,
                                       atol=1e-6)
            ref = lib_out
        for b, lib in builds.items():
            if b in unchecked:
                continue
            a, a2 = k4d_call(lib, case), k4d_call(lib, case)
            for x in (a, a2):
                if not (torch.equal(x.rgb, ref.rgb)
                        and torch.equal(x.wsum, ref.wsum)):
                    d = (x.rgb - ref.rgb).abs().max().item()
                    raise AssertionError(
                        f"K4d {label} {b} differs in bits from the "
                        f"{'library' if gauss else 'plain version'} (max "
                        f"{d})")
        bound_ms, bound_by = _bound(k4_moved(film, p_film, rad, valid), 0)
        with cuda.plain_reference():
            plain = cold_ms(lambda: film.add_samples_det_plain(
                film.init_state(dev), p_film, rad, valid, first), 3)
        log(f"K4d {label}: {p_film.shape[0]} samples from lane {first}, "
            f"window {film.det_window()}, rows "
            f"{film.det_rows(first, p_film.shape[0])}, "
            f"film {film.cropped_resolution}; every checked build bit for "
            f"bit with the {'library' if gauss else 'plain version'}; plain "
            f"{plain:.4f} ms (L2 cold)")
        acc = film.init_state(dev)
        timed = _turns({b: (lambda lib=lib: k4d_call(lib, case, acc))
                        for b, lib in builds.items()}, reps, K4D_KERNELS,
                       cold=True)
        for b in builds:
            r = _row(f"K4d {label}, L2 cold", b, timed[b], bound_ms,
                     bound_by, samples=p_film.shape[0], plain_ms=plain,
                     checked=b not in unchecked)
            rows.append(r)
            _log_row(log, r)
    return rows


def light_step_cases(dev, res=BATH_RES, lanes=LANES):
    """The recorded calls of K15, K16 and K12's lights kernel -> dict:
    ``k15`` and ``k16`` every infinite_sample and infinite_escape call of
    one step of tile BATH_TILE of the bathroom with its film at ``res``, 1
    sample (tools/light_work.py capture_light_step), ``k16`` then the
    camera rays' call of envmap-dof's tile 0 with its film at RES (all on
    the sky); ``k12l`` [(case, light table, its grid (lo, voxel extent,
    voxel counts))]: the bathroom's as its parse fills it, then each light
    of tools/light_work.py's MIXED_SCENE alone (``light_scene``) over the
    mixed scene's grid (K12_BRANCH_CASES), then the Cornell box's
    triangle table over its grid (``k12_grids``)."""
    from ..scene import lightdistrib as LD
    from ..scene.api import parse_scene_string
    from ..utils import fileutil
    from . import light_work as LW

    def scene(name, small, size):
        with open(os.path.join(LW.SCENES, f"{name}.pbrt")) as f:
            text = f.read()
        if small not in text:
            raise ValueError(f"{name}.pbrt's Film line changed")
        return text.replace(small, f'"integer xresolution" [{size[0]}] '
                            f'"integer yresolution" [{size[1]}]')
    fileutil.set_search_directory(LW.SCENES)
    bath = parse_scene_string(scene(
        "bathroom", '"integer xresolution" [320] "integer yresolution" '
        '[180]', res), device=dev).scene
    r = bath.renderer(lanes)
    cap = LW.capture_light_step(r, bath.context(), r.tiles[BATH_TILE])
    env = parse_scene_string(scene(
        "envmap-dof", '"integer xresolution" [64] "integer yresolution" '
        '[64]', RES), device=dev).scene
    r = env.renderer(lanes)
    camera = LW.capture_light_step(r, env.context(),
                                   r.tiles[0])["infinite_escape"][0]
    sky = os.path.join(LW.SCENES, "textures", "sky.exr")

    def grid_of(bundle):
        lo, hi = bundle.world_bounds
        nv, _, ext = LD.voxels(lo, hi)
        return lo, ext, nv
    k12l = [("bathroom grid", bath.lights, grid_of(bath))]
    mixed = grid_of(parse_scene_string(LW.MIXED_SCENE.replace(
        '"textures/sky.exr"', f'"{sky}"'), device=dev).scene)
    for case, name in K12_BRANCH_CASES.items():
        one = parse_scene_string(LW.light_scene(name).replace(
            '"textures/sky.exr"', f'"{sky}"'), device=dev).scene
        k12l.append((case, one.lights, mixed))
    label, lt, lo, ext, nv = k12_grids(dev)[0]
    k12l.append((f"{label} grid (triangles)", lt, (lo, ext, nv)))
    return dict(k15=cap["infinite_sample"],
                k16=cap["infinite_escape"] + [camera], k12l=k12l)


def k15_errors(out, ref):
    """K15's outputs against the plain version's -> (li bit for bit, the
    largest relative error of wi, the target and the pdf)."""
    wi, pdf, li, pt = out
    rwi, rpdf, rli, rpt = ref
    errs = [((a - b).abs().max(-1).values
             / b.abs().max(-1).values.clamp(min=1e-30)).max().item()
            for a, b in ((wi, rwi), (pt, rpt))]
    errs.append(((pdf - rpdf).abs() / rpdf.abs().clamp(min=1e-30))
                .max().item())
    return torch.equal(li, rli), max(errs)


def measure_k15(calls, builds, reps=20, log=print, unchecked=()):
    """K15 on every recorded call of the bathroom step (``calls``: lt, lid,
    p, u): each call's sky lanes logged; every build but those of
    ``unchecked`` held to the plain version (li bit for bit, wi, the
    target and the pdf within 1e-5 relative); every call timed in turns
    (warm, as the step finds its inputs), bounded (tools/light_work.py
    k15_work) -> list of row dicts."""
    from ..scene import lights as L
    from . import light_work as LW
    rows = []
    for i, args in enumerate(calls):
        lt_, lid = args[0], args[1]
        work = LW.k15_work(lt_, lid)
        with cuda.plain_reference():
            ref = L.infinite_sample(*args)
        errs = {}
        for b, lib in builds.items():
            if b in unchecked:
                continue
            bits, err = k15_errors(L.infinite_sample(*args, lib=lib), ref)
            if not bits or err > 1e-5:
                raise AssertionError(f"K15 call {i} {b} differs from the "
                                     f"plain version (li bits {bits}, "
                                     f"relative {err:.3g})")
            errs[b] = err
        with cuda.plain_reference():
            plain = events_ms(lambda: L.infinite_sample(*args), 5)
        bound_ms, bound_by = _bound(work["moved"], work["ops"])
        log(f"K15 call {i}: {work['lanes']} lanes, {work['infinite_lanes']} "
            f"on the sky; li bit for bit, relative errors {errs}; plain "
            f"{plain:.4f} ms")
        timed = _turns({b: (lambda lib=lib: L.infinite_sample(*args,
                                                              lib=lib))
                        for b, lib in builds.items()}, reps, K15_KERNELS)
        for b in builds:
            r = _row(f"K15 call {i}", b, timed[b], bound_ms, bound_by,
                     call=i, plain_ms=plain, rel_err=errs.get(b),
                     checked=b not in unchecked, **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def measure_k16(calls, builds, reps=20, log=print, unchecked=()):
    """K16 on every recorded call of the bathroom step and envmap-dof's
    camera rays (``light_step_cases``): every other build but those of
    ``unchecked`` bit for bit with the library's, the library's largest
    difference from the plain version logged; every call timed in turns
    (a call the sum of its launches, logged), bounded (tools/light_work.py
    k16_work) -> list of row dicts."""
    from ..scene import lights as L
    from . import light_work as LW
    rows = []
    for i, args in enumerate(calls):
        out = L.infinite_escape(*args)
        with cuda.plain_reference():
            ref = L.infinite_escape(*args)
            plain = events_ms(lambda: L.infinite_escape(*args), 5)
        for b, lib in builds.items():
            if lib is not None and b not in unchecked and not torch.equal(
                    L.infinite_escape(*args, lib=lib), out):
                raise AssertionError(f"K16 call {i}: {b} differs in bits "
                                     "from the library")
        mis = len(args) > 3
        work = LW.k16_work(args[0], args[2], mis)
        bound_ms, bound_by = _bound(work["moved"], work["ops"])
        label = f"K16 call {i} ({'MIS' if mis else 'camera'}" + (
            ", envmap-dof)" if i == len(calls) - 1 else ")")
        log(f"{label}: {work['escaped']} of {work['lanes']} lanes escaped; "
            f"every build bit for bit; library against plain max abs "
            f"{(out - ref).abs().max().item():.3g}; plain {plain:.4f} ms")
        launches = {}
        timed = _turns({b: (lambda lib=lib: L.infinite_escape(*args,
                                                              lib=lib))
                        for b, lib in builds.items()}, reps, K16_KERNELS,
                       launches=launches)
        for b in builds:
            r = _row(label, b, timed[b], bound_ms, bound_by, call=i,
                     plain_ms=plain, checked=b not in unchecked,
                     launches={short_name(k): v
                               for k, v in launches[b].items()}, **work)
            rows.append(r)
            _log_row(log, r)
    return rows


def k12l_work(lt, grid, halton):
    """K12's lights kernel over ``grid``: the bytes and operations of
    every light's branch (tools/light_work.py k12_light_work; a full
    sphere's probes outside it through the cone), the probes in."""
    from ..scene import lightdistrib as LD
    from . import light_work as LW
    lo, ext, nv = grid
    dev = halton.device
    v = int(np.prod(nv))
    moved, ops = halton.numel() * halton.element_size(), 0
    for j in range(lt.n_lights):
        cone = 0
        if bool(lt.l_cone[j]):
            corners = LD.voxel_corners(lo, ext, nv, 0, v, dev)
            pts = corners[None] + halton[:, None, :3] * torch.as_tensor(
                ext, device=dev)
            c, rad = lt.l_q_o2w[j, :3, 3], lt.l_q_params[j, 0]
            cone = int((((pts - c) ** 2).sum(-1) > rad * rad).sum())
        w = LW.k12_light_work(lt, j, v, LD.N_SAMPLES, cone)
        moved, ops = moved + w["moved"], ops + w["ops"]
    return moved, ops


def measure_k12l(cases, builds, reps=10, log=print, unchecked=()):
    """K12's lights kernel on each of ``cases`` (``light_step_cases``:
    the bathroom's whole grid, each branch alone, the Cornell box's
    triangle table): every build but those of ``unchecked`` within 1e-5
    relative (or 1e-6 of the column's largest) of the plain version, bit
    for bit with the library's on every table without a point light (whose
    sum the library takes with one divide, not three), and on a table of
    triangle lights bit for bit with K12 (``spatial_grid_contrib``), which
    is timed beside it there as the build "K12"; timed in turns (a call the
    sum of its launches, logged), bounded (``k12l_work``) -> list of row
    dicts."""
    from ..scene import lightdistrib as LD
    rows = []
    for case, lt, grid in cases:
        lo, ext, nv = grid
        dev = lt.l_emit.device
        halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                                 device=dev)
        tri = lt.kinds == {"tri"}

        def fn(lib):
            return LD.grid_contrib_lights(lt, lo, ext, nv, halton, lib=lib)
        with cuda.plain_reference():
            ref = fn(None)
            plain = events_ms(lambda: fn(None), 2)
        top = ref.abs().max(0).values
        errs = {}
        runs = {b: (lambda lib=lib: fn(lib)) for b, lib in builds.items()}
        lib_out = fn(None)
        same = []
        if tri:
            k12 = LD.grid_contrib(lt, lo, ext, nv, halton)
            runs["K12"] = lambda: LD.grid_contrib(lt, lo, ext, nv, halton)
        for b, lib in builds.items():
            if b in unchecked:
                continue
            out = fn(lib)
            d = (out - ref).abs()
            if ((d > 1e-5 * ref.abs()) & (d > 1e-6 * top)).any():
                raise AssertionError(f"K12's lights kernel {b} differs from "
                                     f"the plain version on {case}")
            if tri and not torch.equal(out, k12):
                raise AssertionError(f"K12's lights kernel {b} differs from "
                                     f"K12 on {case}")
            if lib is not None and "point" not in lt.kinds:
                if not torch.equal(out, lib_out):
                    raise AssertionError(f"K12's lights kernel {b} differs "
                                         f"in bits from the library on {case}")
                same.append(b)
            errs[b] = d.max().item()
        moved, ops = k12l_work(lt, grid, halton)
        bound_ms, bound_by = _bound(moved, ops)
        log(f"K12 lights kernel, {case} {tuple(int(x) for x in nv)}: max "
            f"abs err {errs}{', bit for bit with K12' if tri else ''}"
            f"{f', bit for bit with the library: {same}' if same else ''}; "
            f"plain {plain:.4f} ms")
        launches = {}
        timed = _turns(runs, reps, K12L_KERNELS, launches=launches)
        for b in runs:
            r = _row(f"K12L {case}", b, timed[b], bound_ms, bound_by,
                     plain_ms=plain, max_abs_err=errs.get(b),
                     checked=b not in unchecked, bytes=moved,
                     operations=ops,
                     launches={short_name(k): v
                               for k, v in launches[b].items()})
            rows.append(r)
            _log_row(log, r)
    return rows


def sincos_check(log=print):
    """csrc/lights.cuh sincos_bounded against CUDA's sinf and cosf on every
    float32 in [0, 2 pi] (about 1.1e9), on the card -> (floats, mismatches
    of sin, of cos, the largest difference in units in the last place)."""
    src = os.path.join(tempfile.mkdtemp(), "sincos_check.cu")
    with open(src, "w") as f:
        f.write(SINCOS_CHECK_CU)
    lib = ctypes.CDLL(compile_shared(
        "sincos_check", [src], nvcc_command(src) + ["-I", CSRC]))
    out = torch.zeros(4, dtype=torch.int64, device="cuda")
    hi = int(np.array([2 * np.pi], np.float32).view(np.int32)[0])
    lib.rt_sincos_check.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.rt_sincos_check.restype = ctypes.c_int
    if lib.rt_sincos_check(hi, ctypes.c_void_p(out.data_ptr())) != 0:
        raise RuntimeError("sincos_check failed to launch")
    torch.cuda.synchronize()
    res = (hi + 1, *out[:3].tolist())
    log(f"sincos_bounded against sinf / cosf on the {res[0]} floats of "
        f"[0, 2 pi]: {res[1]} / {res[2]} differ, at most {res[3]} ulp")
    return res


SINCOS_CHECK_CU = r"""
#include "lights.cuh"
__global__ void sincos_check_kernel(int hi, unsigned long long* out) {
    for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b <= hi;
         b += (long long)gridDim.x * blockDim.x) {
        const float x = __int_as_float((int)b);
        float s, c;
        rt::sincos_bounded(x, &s, &c);
        const int ds = abs(__float_as_int(s) - __float_as_int(sinf(x)));
        const int dc = abs(__float_as_int(c) - __float_as_int(cosf(x)));
        if (ds) atomicAdd(out, 1ull);
        if (dc) atomicAdd(out + 1, 1ull);
        if (ds || dc) atomicMax(out + 2, (unsigned long long)max(ds, dc));
    }
}
extern "C" int rt_sincos_check(int hi, void* out) {
    sincos_check_kernel<<<132 * 16, 256>>>(hi, (unsigned long long*)out);
    return (int)cudaGetLastError();
}
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another interaction.cu, film.cu, film_bwd.cu, "
                         "atlas.cu, compact.cu, atlas_bwd.cu, gather_bwd.cu, "
                         "lightdistrib.cu, mipmap.cu or fourier.cu to time "
                         "(repeatable)")
    ap.add_argument("--time-only", action="append", default=[],
                    help="a diagnostic film_bwd.cu, mipmap.cu, "
                         "mipmap_bwd.cu, interaction.cu, film.cu, lights.cu "
                         "or lightdistrib.cu, timed on the K9F, K17, K20, "
                         "K2, K4d, K15, K16 or K12L calls unchecked "
                         "(tools/k9_parts.py, k17_parts.py, k20_parts.py, "
                         "k2_parts.py, k4d_parts.py, k15_parts.py, "
                         "k16_parts.py, k12l_parts.py; repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to measure, of "
                         f"{','.join(KERNELS)}")
    ap.add_argument("--k12-corners", action="store_true",
                    help="each --other lightdistrib.cu takes voxel corners, "
                         "once a chunk (the per-chunk C interface)")
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
    builds, reports, sass, channels = build(args.other + args.time_only,
                                            args.k12_corners)
    for name, lines in reports.items():
        for ln in lines:
            print(f"ptxas [{name}] {ln}", flush=True)
    for name, fns in sass.items():
        for fn, ops in fns.items():
            print(f"sass [{name}] {fn}: {' '.join(ops)}", flush=True)
    dev = torch.device("cuda:0")
    which = args.kernels.split(",")
    if {"K15", "K4d", "K16", "K12L"} & set(which):
        # the registers and stack frames of K15, K16 and K12's lights
        # kernel (each instantiation, K12's kernel among them) and K4d's
        # tile's shared memory, and sincos_bounded against sinf and cosf
        files = ("lights.cu", "film.cu", "lightdistrib.cu")
        srcs = [os.path.join(CSRC, f) for f in files] + [
            p for p in args.other + args.time_only
            if os.path.basename(p) in files]
        for src in srcs:
            for fn, ln in res_usage(src).items():
                if any(k in fn for k in ("infinite_sample", "film_add_det",
                                         "infinite_escape",
                                         "grid_contrib_")):
                    print(f"res-usage [{src}] {fn}: {ln}", flush=True)
        if "K15" in which:
            sincos_check()
    lights = light_step_cases(dev) if {"K15", "K16", "K12L"} & set(which) \
        else None
    if [k for k in which if k not in ("K17", "K19", "K20", "K15", "K16",
                                      "K12L")]:
        ctx, cam, film, sampler, integ, _ = build_dragon(res=RES, device=dev)
        r = Renderer(integ.li, cam, film, sampler,
                     RenderConfig(max_lanes=LANES), device=dev)
        cap = capture_step(r, ctx, r.tiles[STEP_TILE])
        cap["k7"] = capture_step(r, ctx, r.tiles[SLAB_TILE])["k7"]
        cap["k4f"] = filtered_splat(r, ctx, STEP_TILE)
        grad = capture_grad_step(r, ctx, r.tiles[STEP_TILE])
        grads = {kind: filtered_grad_step(r, ctx, STEP_TILE, kind=kind)
                 for kind in FILTERS} if "K9F" in which else {}
        print(f"step of tile {STEP_TILE}: {len(cap['k4'])} K4, "
              f"{len(cap['k5'])} K5 and {len(cap['k6'])} K6 calls, "
              f"{len(grad['k10'])} K10 and {len(grad['k11'])} K11 calls in "
              f"its backward; step of tile {SLAB_TILE}: {len(cap['k7'])} K7 "
              "take", flush=True)
    shading = capture_shading(dev, [n for k, n in (("K17", K17_SCENE),
                                                   ("K19", K19_SCENE))
                                    if k in which])
    log = lambda s: print(s, flush=True)   # noqa: E731
    if "K2" in which:
        # the library's kernel launched as the other builds are, for the
        # gap between the library's K2 and the same source built alone
        builds[K2] = dict(builds[K2], **{"library direct": cuda.library()})
        compare_k2_sass(builds[K2], log)
    measure = {
        "K2": lambda: measure_k2(
            {**k2_cases(ctx, cam, sampler, r), **k2_step_cases(dev)},
            builds[K2], args.reps, log, unchecked=args.time_only),
        "K4": lambda: measure_k4(cap, builds[K4], channels, args.reps, log),
        "K5": lambda: measure_k5(ctx, cap, builds[K5], args.reps, log),
        "K6": lambda: measure_k6(cap, builds[K6], args.reps, log),
        "K7": lambda: measure_k7(cap, builds[K7], args.reps, log),
        "K10": lambda: measure_k10(grad, builds[K10], args.reps, log),
        "K11": lambda: measure_k11(grad, builds[K11], args.reps, log),
        "K12": lambda: measure_k12(k12_grids(dev, ctx), builds[K12],
                                   args.reps, log),
        "K4F": lambda: measure_k4f(cap, builds[K4], channels, args.reps,
                                   log),
        "K9F": lambda: measure_k9f(grads, builds[K9], args.reps, log,
                                   unchecked=args.time_only),
        "K17": lambda: measure_k17(shading[K17_SCENE], builds[K17],
                                   args.reps, log, unchecked=args.time_only),
        "K19": lambda: measure_k19(shading[K19_SCENE],
                                   wide_fourier_calls(dev), builds[K19],
                                   args.reps, log),
        "K20": lambda: measure_k20(capture_k20(dev), builds[K20], args.reps,
                                   log, unchecked=args.time_only),
        "K4d": lambda: measure_k4d(k4d_cases(r, ctx, dev), builds[K4D],
                                   args.reps, log, unchecked=args.time_only),
        "K15": lambda: measure_k15(lights["k15"], builds[K15], args.reps,
                                   log, unchecked=args.time_only),
        "K16": lambda: measure_k16(lights["k16"], builds[K16], args.reps,
                                   log, unchecked=args.time_only),
        "K12L": lambda: measure_k12l(lights["k12l"], builds[K12L],
                                     max(args.reps // 2, 1), log,
                                     unchecked=args.time_only)}
    rows = [r for k in which for r in measure[k]()]
    out = dict(card=card, ptxas=reports, sass=sass, rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
