"""Inputs, comparisons and bounds of the path chain's hand kernels K21-K23
(ops/pathshade.py); shared by chip_smoke.py and the tests.

- ``capture_path_step``: every K21, K22 and K23 call of one renderer step,
  in order, its arguments cloned (the interaction, path state and lobes
  field by field).
- ``compare_with_twin``: one recorded call through the kernel and
  through its plain twin on the same inputs -> each output's
  differing lanes and largest distance in float32 ulps.
- ``k21_work``, ``k22_work``, ``k23_work``: a call's bytes (each input a
  lane must read, each output written, the light rows once) and
  operations, counted on its data (chip_smoke.py's ``bound`` turns them
  into the least time on one H100). K21 needs the hit's normal and the
  MIS inputs only on the lanes that hit a light, and wo only where that
  light is one-sided: they are counted on those lanes alone.

Operations are float32 operations at one each (a divide, a square root, a
reciprocal square root, compares and selects included), cosf and sinf at
``light_work.SIN_OPS``, counted from csrc/pathshade.cu.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .light_work import SIN_OPS

NAMES = ("path_hit_emit", "path_scatter_lambert", "path_nee_add")
# the CUDA kernels each entry point launches (torch.profiler's names)
KERNEL_NAMES = {"path_hit_emit": "path_hit_emit_kernel",
                "path_scatter_lambert": "path_scatter_lambert_kernel",
                "path_nee_add": "path_nee_add_kernel"}

# K21 a lane: valid, the light test 2, L + beta lw 6, alive 2, path_len
# 1; a lane that hits a light: the row's clamp, arealight_le (dot 5,
# compare, the twosided or, select 3), the weight 3; after a bounce also
# pdf_li_hit (difference 3, dot 5, clamp, |dot| 6, area product, clamp,
# divide, the mask), the pmf's product, the power heuristic 6 and its
# select
K21_OPS = 1 + 2 + 6 + 2 + 1
K21_LIGHT_OPS = 1 + 10 + 3
K21_BOUNCE_OPS = 3 + 5 + 1 + 6 + 1 + 1 + 1 + 1 + 1 + 6 + 1
# K22 a lane: wo's local frame 15 and its geometric cosine 5; the light
# sample (sqrt, the barycentrics 4, the point 15, the normal's cross 9 and
# normalisation 10, the error 21, the flip 3, d 3, dist2 6, wi 5, cos 8,
# facing 2, li 3, the pdf 5, the pmf's product); wi's local frame 15; f
# (the reflect test 7, the hemisphere 2, the lobe 6, |wo.z| 2, the cosine
# 4) and pdf 6; possible 10, the power heuristic 6, the weight over the
# pdf 3, ld 9, pending 6; two offset_ray_origin (40 each) and d 3, t_max;
# the bounce (clamp, the concentric map 13 with cosf and sinf, z 6, the
# flip 2, the world and local frames 30, f 21 and pdf 6, ok 3, selects 4,
# the contribution 6, alive 6, beta 6, offset_ray_origin 40, t_max)
K22_OPS = (20 + 1 + 4 + 15 + 19 + 21 + 3 + 3 + 6 + 5 + 8 + 2 + 3 + 5 + 1
           + 15 + 21 + 6 + 10 + 6 + 3 + 9 + 6 + 80 + 3 + 1
           + 1 + 13 + 2 * SIN_OPS + 6 + 2 + 30 + 21 + 6 + 3 + 4 + 6 + 6 + 6
           + 40 + 1)
# Russian roulette: the products 3, max 2, q 2, the compares 2, alive 3,
# the divisor 2, the divides 3, the select 3
K22_RR_OPS = 20
K23_OPS = 6
# a triangle light row: tri_p, emit, area, tri_rev, twosided (K22); K21
# reads twosided, emit and area
LIGHT_ROW_BYTES = 36 + 12 + 4 + 1 + 1
K21_ROW_BYTES = 1 + 12 + 4


def _clone(x):
    """Tensors cloned, dataclasses and NamedTuples field by field."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    return x


@contextlib.contextmanager
def record_path_calls(into):
    """Within the scope, each call of ops/pathshade.py's K21, K22 and K23
    wrappers stores its arguments, cloned, in ``into[name]`` (a list, in
    order)."""
    from ..ops import pathshade
    orig = {name: getattr(pathshade, name) for name in NAMES}

    def recorder(name):
        def recorded(*args):
            into.setdefault(name, []).append(tuple(_clone(a) for a in args))
            return orig[name](*args)
        return recorded

    for name in NAMES:
        setattr(pathshade, name, recorder(name))
    try:
        yield
    finally:
        for name in NAMES:
            setattr(pathshade, name, orig[name])


def capture_path_step(renderer, ctx, tile, sample=1) -> dict:
    """One step of ``tile`` at ``sample`` -> {name: [args, ...]}: every
    K21, K22 and K23 call of the step, in order (K21's first the camera
    rays', its last the final emission-only bounce)."""
    calls = {}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with record_path_calls(calls):
        renderer.step(ctx, fs, px, py, sample, v)
    return calls


def call(name, args):
    """The wrapper ``name`` of ops/pathshade.py on ``args`` -> its outputs
    as a tuple of tensors, with their field names."""
    from ..ops import pathshade
    out = getattr(pathshade, name)(*args)
    if name == "path_hit_emit":
        return out, ("valid", "L", "alive", "path_len")
    if name == "path_scatter_lambert":
        return tuple(out), out._fields
    return (out,), ("L",)


def _ordered(x):
    """float32 -> int64 keys in the floats' order (-0 and +0 apart by 1)."""
    b = x.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


def compare_with_twin(name, args) -> dict:
    """One call through the kernel and through its plain twin
    (``cuda.plain_reference()``) on the same inputs ->
    {field: dict(lanes, differ, ulps, abs)}: the lanes whose outputs differ
    (a NaN equals a NaN), the largest distance in float32 ulps and the
    largest absolute difference (0 for the bool and int fields, which must
    be equal)."""
    from .. import cuda
    got, fields = call(name, args)
    with cuda.plain_reference():
        ref, _ = call(name, args)
    out = {}
    for field, a, b in zip(fields, got, ref):
        a, b = a.detach(), b.detach()
        if a.dtype == torch.float32:
            both_nan = torch.isnan(a) & torch.isnan(b)
            ulps = torch.where(both_nan, 0, (_ordered(a) - _ordered(b)).abs())
            diff = torch.where(both_nan | (a == b), 0.0, (a - b).abs())
        else:
            ulps = (a != b).to(torch.int64)
            diff = ulps.float()
        if ulps.dim() > 1:
            ulps = ulps.amax(-1)
            diff = diff.amax(-1)
        out[field] = dict(lanes=int(ulps.numel()), differ=int((ulps > 0).sum()),
                          ulps=int(ulps.max()) if ulps.numel() else 0,
                          abs=float(diff.max()) if diff.numel() else 0.0)
    return out


def k21_work(args) -> dict:
    """K21 on one call's arguments (lt, si, d, st, pmf, first): ``lights``
    the lanes that hit a light on a live path."""
    lt, si, d, st, pmf, first = args
    n = st.L.shape[0]
    hit = si.valid & st.alive & (si.arealight >= 0)
    k = int(hit.sum())
    rows = si.arealight.clamp(min=0, max=max(lt.n_lights - 1, 0))
    one_sided = int((hit & ~lt.l_twosided[rows]).sum())
    # in: valid, arealight, material, L, beta, alive, path_len; on the
    # lanes that hit a light n, and wo where the light is one-sided; after
    # a bounce there also p, d, prev_p, prev_pdf, prev_spec and a pmf table
    moved = n * (1 + 4 + 4 + 12 + 12 + 1 + 4) + k * 12 + one_sided * 12
    ops = n * K21_OPS + k * K21_LIGHT_OPS
    if not first:
        moved += k * (12 + 12 + 12 + 4 + 1
                      + (4 if isinstance(pmf, torch.Tensor) else 0))
        ops += k * K21_BOUNCE_OPS
    # out: valid, L, alive, path_len; the light rows
    moved += n * (1 + 12 + 1 + 4) + lt.n_lights * K21_ROW_BYTES
    return dict(lanes=n, lights=k, moved=moved, ops=ops)


def k22_work(args) -> dict:
    """K22 on one call's arguments (lt, si, lobes, st, lid, pmf, u_light,
    u_lobe, u2, u_rr, rr_threshold): u_lobe is not read (it picks the one
    lobe), the lobe's params only its reflectance."""
    lt, si, lobes, st, lid, pmf, u_light, u_lobe, u2, u_rr, _ = args
    n = st.beta.shape[0]
    rr = u_rr is not None
    # in: the frame and hit (7 x 12, valid), the lobe's reflectance and
    # active flag, alive, beta, lid, u_light, u2, a pmf table, eta_scale
    # and u_rr with Russian roulette
    moved = n * (7 * 12 + 1 + 12 + 1 + 1 + 12 + 4 + 8 + 8
                 + (4 if isinstance(pmf, torch.Tensor) else 0)
                 + (8 if rr else 0))
    # out: ray o, d, t_max, beta, alive, prev_pdf, prev_spec, the shadow
    # ray's o, d, t_max, pending; the light rows
    moved += n * (12 + 12 + 4 + 12 + 1 + 4 + 1 + 12 + 12 + 4 + 12) \
        + lt.n_lights * LIGHT_ROW_BYTES
    ops = n * (K22_OPS + (K22_RR_OPS if rr else 0))
    return dict(lanes=n, moved=moved, ops=ops)


def k23_work(args) -> dict:
    """K23 on one call's arguments (L, pending, occluded)."""
    n = args[0].shape[0]
    return dict(lanes=n, moved=n * (12 + 12 + 1 + 12), ops=n * K23_OPS)


WORK = {"path_hit_emit": k21_work, "path_scatter_lambert": k22_work,
        "path_nee_add": k23_work}
