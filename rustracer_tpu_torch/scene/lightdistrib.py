"""The spatial light grid (port of rustracer_tpu/scene/lightdistrib.py) with
hand kernels K12 and K13 (csrc/lightdistrib.cu).

A dense voxel grid over the scene's bounds holds, per voxel, a pmf and a
cdf over the lights, estimated from 128 Halton probes of every light's
unoccluded contribution; a lane picks a light from the row of the voxel
it stands in. The host part of ``build_spatial_grid`` (voxel counts, the
Halton table, the floor, pmf and cdf in numpy float32) is the reference's,
line for line; the voxels' contribution sums come from K12
``spatial_grid_contrib``, one launch over the whole grid (plain version
``grid_contrib_all_plain``), or, for a scene with point, distant, quadric
area or infinite lights, its sibling ``spatial_grid_contrib_lights``
(``grid_contrib_lights``), which adds a branch for each of those types (a
light a block row, so a block's type is uniform).
``sample_light`` and ``pmf_lookup`` are K13 ``spatial_light_pick`` and
``spatial_pmf_lookup`` (plain versions beside them).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import cuda
from ..core.math import dot
from ..ops.triangle import triangle_sample
from ..utils.stats import time_phase
from . import lights as L
from .lights import Y_WEIGHTS

PRIMES = (2, 3, 5, 7, 11)
N_SAMPLES = 128          # probes a voxel
MAX_VOXELS = 64          # voxels on the bounds' widest axis
MIN_CONTRIB_FRAC = 1e-3  # floor: no light's probability is 0
# the timers of build_spatial_grid's pieces (utils/stats.py)
GRID_PHASE = "scene/spatial light distribution/"
# a probe's operations in K12's inner loop, counted from its code (32-bit
# float operations, compares and selects at one instruction each, the
# approximate reciprocal square root as one): the point 3 adds, d 3
# subtracts, dist2 3 multiplies, 2 adds and a max, rsqrtf 1, cos_l 3
# multiplies, 2 adds and the multiply by rs, its abs 1, the facing test's
# select and compare 2, the contribution's multiply, max, 2 multiplies by
# rs, min and multiply by y 6, its select and the sum 2. (The per-chunk
# kernel before it, with a correctly rounded square root, two divides and
# the probe point's 3 multiplies, counted 42.)
K12_PROBE_OPS = 30
# voxels a chunk of the plain version covers (its (S, C, 3) temporaries)
CHUNK_VOXELS = 1 << 14


def _radical_inverse_table(n_samples: int) -> np.ndarray:
    """(n_samples, 5) Halton points, bases 2, 3, 5, 7, 11: 3 dimensions
    for the voxel point, 2 for the light sample."""
    out = np.zeros((n_samples, len(PRIMES)), np.float64)
    for d, base in enumerate(PRIMES):
        for i in range(n_samples):
            x, inv, j = 0.0, 1.0 / base, i
            while j:
                x += (j % base) * inv
                inv /= base
                j //= base
            out[i, d] = x
    return out.astype(np.float32)


@dataclasses.dataclass
class SpatialLightGrid:
    """Dense per-voxel light pmf and cdf tables on the device; the voxel
    map's constants also as host values (K13 takes them by value)."""
    world_lo: torch.Tensor       # (3,)
    world_inv_ext: torch.Tensor  # (3,)
    n_voxels: torch.Tensor       # (3,) int32
    strides: torch.Tensor        # (3,) int32 flat-index strides
    pmf: torch.Tensor            # (V, n_lights)
    cdf: torch.Tensor            # (V, n_lights) inclusive, last column 1
    host: Tuple                  # (lo (3,), inv_ext (3,), nv (3,)) numpy

    @property
    def n_lights(self):
        return self.pmf.shape[1]


def _y_over_pdf(li, pdf):
    y = Y_WEIGHTS[0] * li[..., 0] + Y_WEIGHTS[1] * li[..., 1] \
        + Y_WEIGHTS[2] * li[..., 2]
    return torch.where(pdf > 0.0, y / torch.clamp(pdf, min=1e-20), 0.0)


def _probe_contrib(lt, j, pts, u):
    """y(li) / pdf of light row j's sample_li at the probe points pts (S,
    C, 3) with the probes' u (S, 2) -> (S, C). A distant or infinite
    light's sample does not depend on the point: its S values are computed
    once and broadcast over the voxels."""
    n_s, c = pts.shape[0], pts.shape[1]
    kinds = L.row_kinds(lt, j)
    if kinds & {"distant", "infinite"}:
        probe = _Probe(pts[:, 0])
        ls = L.sample_li(lt, torch.full((n_s,), j, dtype=torch.int32,
                                        device=pts.device), probe, u, kinds)
        return _y_over_pdf(ls.li, ls.pdf)[:, None].expand(n_s, c)
    probe = _Probe(pts.reshape(-1, 3))
    ls = L.sample_li(lt, torch.full((n_s * c,), j, dtype=torch.int32,
                                    device=pts.device), probe,
                     u[:, None].expand(n_s, c, 2).reshape(-1, 2), kinds)
    return _y_over_pdf(ls.li, ls.pdf).reshape(n_s, c)


@dataclasses.dataclass
class _Probe:
    """The interaction of a grid probe: its point only."""
    p: torch.Tensor


def grid_contrib_plain(lt, vox_lo, vox_ext, halton):
    """The contribution sums of voxels with lower corners ``vox_lo`` (C, 3)
    -> (C, n_lights): over the probes, y(li) / pdf where pdf > 0, each
    light's sample as scene/lights.py sample_li computes it (a triangle's
    point and normal of a probe, which depend on the probe and the light
    only, computed once; the probes summed in order)."""
    n_s = halton.shape[0]
    ext = torch.as_tensor(vox_ext, device=vox_lo.device)
    pts = vox_lo[None] + (halton[:, None, :3] * ext)   # (S, C, 3)
    cols = []
    for j in range(lt.n_lights):
        if int(lt.l_type[j]) != L.LIGHT_AREA or int(lt.l_q_type[j]) >= 0:
            contrib = _probe_contrib(lt, j, pts, halton[:, 3:5])
            acc = torch.zeros_like(contrib[0])
            for s in range(n_s):
                acc = acc + contrib[s]
            cols.append(acc)
            continue
        tri = lt.l_tri_p[j]
        u = halton[:, 3:5]
        p_a, n_a, _ = triangle_sample(u, tri[0].expand(n_s, 3),
                                      tri[1].expand(n_s, 3),
                                      tri[2].expand(n_s, 3))
        n_a = torch.where(lt.l_tri_rev[j], -n_a, n_a)
        d_a = p_a[:, None] - pts
        dist2 = torch.clamp(dot(d_a, d_a), min=1e-12)
        wi = d_a * torch.rsqrt(torch.clamp(dist2, min=1e-20))[..., None]
        cos_l = dot(n_a[:, None], -wi)
        facing = torch.where(lt.l_twosided[j], torch.abs(cos_l) > 1e-7,
                             cos_l > 1e-7)
        e = lt.l_emit[j]
        y = 0.212671 * e[0] + 0.715160 * e[1] + 0.072169 * e[2]
        y = torch.where(facing, y, 0.0)
        pdf = dist2 / torch.clamp(torch.abs(cos_l) * lt.l_area[j], min=1e-12)
        pdf = torch.where(facing, pdf, 0.0)
        contrib = torch.where(pdf > 0.0, y / torch.clamp(pdf, min=1e-20),
                              0.0)
        acc = torch.zeros_like(contrib[0])
        for s in range(n_s):
            acc = acc + contrib[s]
        cols.append(acc)
    return torch.stack(cols, -1)


def voxel_corners(world_lo, vox_ext, nv, start, stop, device="cpu"):
    """Lower corners (stop - start, 3) float32 of the voxels with flat
    indices [start, stop) of an ``nv`` grid, as K12 computes each from its
    index: flat = (ix * ny + iy) * nz + iz, corner = world_lo + float(i) *
    vox_ext (a float32 multiply, then an add)."""
    flat = torch.arange(start, stop, device=device)
    ny, nz = int(nv[1]), int(nv[2])
    idx = torch.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz], -1)
    lo = torch.as_tensor(np.asarray(world_lo, np.float32), device=device)
    ext = torch.as_tensor(np.asarray(vox_ext, np.float32), device=device)
    return lo + idx.float() * ext


def grid_contrib_all_plain(lt, world_lo, vox_ext, nv, halton,
                           chunk_voxels: int = CHUNK_VOXELS):
    """Plain version of K12: the contribution sums (V, n_lights) of every
    voxel of the grid, ``chunk_voxels`` at a time (``voxel_corners``,
    ``grid_contrib_plain``)."""
    v = int(np.prod(nv))
    dev = halton.device
    return torch.cat([
        grid_contrib_plain(lt, voxel_corners(world_lo, vox_ext, nv, s,
                                             min(s + chunk_voxels, v), dev),
                           vox_ext, halton)
        for s in range(0, v, chunk_voxels)], 0)


def _grid_args(lt, world_lo, vox_ext, nv, halton):
    """The grid's scalars of a K12 launch (lo, voxel extent, voxel counts),
    after the tables both kernels read are checked -> (grid, out)."""
    dev = halton.device
    n_l, n_s = lt.n_lights, halton.shape[0]
    cuda.check(halton, "halton", torch.float32, (n_s, 5), dev)
    cuda.check(lt.l_tri_p, "l_tri_p", torch.float32, (n_l, 3, 3), dev)
    cuda.check(lt.l_emit, "l_emit", torch.float32, (n_l, 3), dev)
    for t, name in ((lt.l_tri_rev, "l_tri_rev"),
                    (lt.l_twosided, "l_twosided")):
        cuda.check(t, name, torch.bool, (n_l,), dev)
    cuda.check(lt.l_area, "l_area", torch.float32, (n_l,), dev)
    nv = [int(x) for x in nv]
    grid = [*[float(x) for x in np.asarray(world_lo, np.float32)],
            *[float(x) for x in np.asarray(vox_ext, np.float32)], *nv]
    out = torch.empty((int(np.prod(nv)), n_l), dtype=torch.float32,
                      device=dev)
    return grid, out


def grid_contrib(lt, world_lo, vox_ext, nv, halton):
    """K12: the contribution sums (V, n_lights) of every voxel of the grid
    with lower corner ``world_lo``, voxel extent ``vox_ext`` (3,) float32
    and ``nv`` (3,) voxels an axis, in C order; one launch. A scene of
    triangle lights launches ``spatial_grid_contrib``, any other
    ``grid_contrib_lights``. CPU tensors take the plain version."""
    if not cuda.use_kernel(halton):
        return grid_contrib_all_plain(lt, world_lo, vox_ext, nv, halton)
    if lt.kinds != {"tri"}:
        return grid_contrib_lights(lt, world_lo, vox_ext, nv, halton)
    grid, out = _grid_args(lt, world_lo, vox_ext, nv, halton)
    cuda.launch("spatial_grid_contrib", *grid, halton, halton.shape[0],
                lt.l_tri_p, lt.l_tri_rev, lt.l_twosided, lt.l_emit,
                lt.l_area, lt.n_lights, out)
    return out


def grid_contrib_lights(lt, world_lo, vox_ext, nv, halton, lib=None):
    """K12 ``spatial_grid_contrib_lights``, ``grid_contrib`` for a table of
    any light types; one ``cuda.launch``, which launches K12's triangle
    kernel over every row (a block of another branch's row returns at
    once) and then one kernel a set of the other branches
    (csrc/lightdistrib.cu ``LightSets``), whose blocks take the items of
    the set's rows from a queue an SM: nothing is read back. It takes a
    table of triangle lights too. CPU tensors take the plain
    version; ``lib``, a loaded other build, is launched uncounted."""
    if not cuda.use_kernel(halton):
        return grid_contrib_all_plain(lt, world_lo, vox_ext, nv, halton)
    dev = halton.device
    n_l = lt.n_lights
    grid, out = _grid_args(lt, world_lo, vox_ext, nv, halton)
    for t, name, dt, shape in (
            (lt.l_type, "l_type", torch.int32, (n_l,)),
            (lt.l_pos, "l_pos", torch.float32, (n_l, 3)),
            (lt.l_q_type, "l_q_type", torch.int32, (n_l,)),
            (lt.l_q_o2w, "l_q_o2w", torch.float32, (n_l, 4, 4)),
            (lt.l_q_w2o, "l_q_w2o", torch.float32, (n_l, 4, 4)),
            (lt.l_q_params, "l_q_params", torch.float32, (n_l, 4)),
            (lt.l_q_rev, "l_q_rev", torch.bool, (n_l,)),
            (lt.l_cone, "l_cone", torch.bool, (n_l,)),
            (lt.row_inf, "row_inf", torch.int32, (n_l,)),
            (lt.inf_desc, "inf_desc", torch.int32, (lt.n_infinite, 9)),
            (lt.inf_l2w, "inf_l2w", torch.float32, (lt.n_infinite, 4, 4)),
            (lt.inf_flat, "inf_flat", torch.float32,
             tuple(lt.inf_flat.shape))):
        cuda.check(t, name, dt, shape, dev)
    cuda.launch("spatial_grid_contrib_lights", *grid, halton,
                halton.shape[0], lt.l_type, lt.l_pos, lt.l_emit,
                lt.l_twosided, lt.l_area, lt.l_tri_p, lt.l_tri_rev,
                lt.l_q_type, lt.l_q_o2w, lt.l_q_w2o, lt.l_q_params,
                lt.l_q_rev, lt.l_cone, lt.row_inf, lt.inf_flat, lt.inf_desc,
                lt.inf_l2w, n_l, out, lib=lib)
    return out


def voxels(world_lo, world_hi, max_voxels: int = MAX_VOXELS):
    """The grid over the bounds: the widest axis gets ``max_voxels``
    voxels, the others in proportion. -> (nv (3,) int64, diag (3,), the
    voxel extent (3,)), float32 numpy (``voxel_corners`` gives the
    voxels' lower corners)."""
    world_lo = np.asarray(world_lo, np.float32)
    world_hi = np.asarray(world_hi, np.float32)
    diag = np.maximum(world_hi - world_lo, 1e-6)
    b_max = float(diag.max())
    nv = np.maximum(1, np.round(diag / b_max * max_voxels)).astype(np.int64)
    return nv, diag, (diag / nv).astype(np.float32)


def build_spatial_grid(lt, world_lo, world_hi, max_voxels: int = MAX_VOXELS,
                       n_samples: int = N_SAMPLES) -> SpatialLightGrid:
    """The full voxel grid of light-selection pmfs on ``lt``'s device, the
    voxels' contributions from K12 in one launch. Its pieces are timed
    (utils/stats.py) under ``GRID_PHASE``."""
    dev = lt.l_emit.device
    world_lo = np.asarray(world_lo, np.float32)
    nv, diag, vox_ext = voxels(world_lo, world_hi, max_voxels)
    n_l = lt.n_lights
    with time_phase(GRID_PHASE + "Halton table"):
        halton = torch.as_tensor(_radical_inverse_table(n_samples),
                                 device=dev)
    with time_phase(GRID_PHASE + "contributions (K12)"):
        contrib = grid_contrib(lt, world_lo, vox_ext, nv, halton)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with time_phase(GRID_PHASE + "copy back"):
        contrib = contrib.cpu().numpy()   # (V, n_l)

    with time_phase(GRID_PHASE + "pmf and cdf"):
        # floor so no light has zero probability
        avg = contrib.sum(-1, keepdims=True) / (n_samples * n_l)
        min_c = np.where(avg > 0.0, MIN_CONTRIB_FRAC * avg, 1.0)
        contrib = np.maximum(contrib, min_c)
        pmf = contrib / contrib.sum(-1, keepdims=True)
        cdf = np.cumsum(pmf, -1)
        cdf[:, -1] = 1.0

    strides = np.array([nv[1] * nv[2], nv[2], 1], np.int32)
    inv_ext = (1.0 / diag).astype(np.float32)
    with time_phase(GRID_PHASE + "tables to the device"):
        return SpatialLightGrid(
            world_lo=torch.as_tensor(world_lo, device=dev),
            world_inv_ext=torch.as_tensor(inv_ext, device=dev),
            n_voxels=torch.as_tensor(nv.astype(np.int32), device=dev),
            strides=torch.as_tensor(strides, device=dev),
            pmf=torch.as_tensor(pmf.astype(np.float32), device=dev),
            cdf=torch.as_tensor(cdf.astype(np.float32), device=dev),
            host=(world_lo, inv_ext, nv.astype(np.int32)))


def voxel_index(grid: SpatialLightGrid, p):
    """Flat voxel index (B,) int64 of world points p (B, 3): (p - lo) *
    inv_ext * n_voxels truncated toward zero, a value beyond the int32
    range saturating and NaN going to 0 (as the reference's cast), then
    clipped into the grid."""
    f = ((p - grid.world_lo) * grid.world_inv_ext) * grid.n_voxels
    nv = grid.n_voxels.to(f.dtype)
    f = torch.minimum(torch.clamp(torch.nan_to_num(f, nan=0.0), min=-1.0),
                      nv)
    vi = torch.minimum(torch.clamp(f.int(), min=0), grid.n_voxels - 1)
    return (vi.long() * grid.strides.long()).sum(-1)


def sample_light_plain(grid: SpatialLightGrid, p, u):
    """Plain version of K13's pick: lid = min(count(u >= cdf row), n - 1)
    and its pmf."""
    flat = voxel_index(grid, p)
    cdf_rows = grid.cdf[flat]
    n_l = grid.n_lights
    lid = torch.clamp((u[:, None] >= cdf_rows).int().sum(-1), max=n_l - 1)
    pmf = torch.gather(grid.pmf[flat], 1, lid[:, None].long())[:, 0]
    return lid.int(), pmf


def pmf_lookup_plain(grid: SpatialLightGrid, p, lid):
    """Plain version of K13's lookup: the pmf of light ``lid`` (clipped)
    in the voxel of p."""
    flat = voxel_index(grid, p)
    lid_c = torch.clamp(lid, 0, grid.n_lights - 1).long()
    return torch.gather(grid.pmf[flat], 1, lid_c[:, None])[:, 0]


def _host_args(grid: SpatialLightGrid):
    lo, inv_ext, nv = grid.host
    return [float(x) for x in lo] + [float(x) for x in inv_ext] \
        + [int(x) for x in nv]


def sample_light(grid: SpatialLightGrid, p, u):
    """Per-lane light pick: p (B, 3) world points, u (B,) uniforms ->
    (lid (B,) int32, pmf (B,) float32). CUDA tensors launch K13."""
    if not cuda.use_kernel(p):
        return sample_light_plain(grid, p, u)
    n, dev = p.shape[0], p.device
    cuda.check(p, "p", torch.float32, (n, 3), dev)
    cuda.check(u, "u", torch.float32, (n,), dev)
    v, n_l = grid.pmf.shape
    cuda.check(grid.cdf, "cdf", torch.float32, (v, n_l), dev)
    cuda.check(grid.pmf, "pmf", torch.float32, (v, n_l), dev)
    lid = torch.empty(n, dtype=torch.int32, device=dev)
    pmf = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        cuda.launch("spatial_light_pick", p, u, n, *_host_args(grid),
                    grid.cdf, grid.pmf, n_l, lid, pmf)
    return lid, pmf


def pmf_lookup(grid: SpatialLightGrid, p, lid):
    """Selection probability of light ``lid`` (B,) at points p (B, 3): the
    density the emission-hit side of MIS pairs with ``sample_light``'s
    picks. CUDA tensors launch K13."""
    if not cuda.use_kernel(p):
        return pmf_lookup_plain(grid, p, lid)
    n, dev = p.shape[0], p.device
    cuda.check(p, "p", torch.float32, (n, 3), dev)
    cuda.check(lid, "lid", torch.int32, (n,), dev)
    v, n_l = grid.pmf.shape
    cuda.check(grid.pmf, "pmf", torch.float32, (v, n_l), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        cuda.launch("spatial_pmf_lookup", p, lid, n, *_host_args(grid),
                    grid.pmf, n_l, out)
    return out
