"""The spatial light grid (port of rustracer_tpu/scene/lightdistrib.py) with
hand kernels K12 and K13 (csrc/lightdistrib.cu).

A dense voxel grid over the scene's bounds holds, per voxel, a pmf and a
cdf over the lights, estimated from 128 Halton probes of every light's
unoccluded contribution; a lane picks a light from the row of the voxel
it stands in. The host part of ``build_spatial_grid`` (voxel counts, the
Halton table, the floor, pmf and cdf in numpy float32) is the reference's,
line for line; the voxels' contribution sums come from K12
``spatial_grid_contrib`` (plain version ``grid_contrib_plain``).
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

PRIMES = (2, 3, 5, 7, 11)
N_SAMPLES = 128          # probes a voxel
MAX_VOXELS = 64          # voxels on the bounds' widest axis
MIN_CONTRIB_FRAC = 1e-3  # floor: no light's probability is 0
# a probe's operations in K12's inner loop, counted from its code (32-bit
# float operations and compares at one instruction each; the sqrt and the
# divides as one each): the point 6, d 3, dot 5, two fmaxf 2, the
# reciprocal square root 2, wi 3, cos_l 3 negations + 5, the facing test
# 2, the pdf's abs, multiply, fmaxf and divide 4, two selects 2, the
# contribution's compare, fmaxf, divide, select and sum 5
K12_PROBE_OPS = 42
# voxels a K12 launch or a plain chunk covers
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


def grid_contrib_plain(lt, vox_lo, vox_ext, halton):
    """Plain version of K12: (C, 3) voxel lower corners -> (C, n_lights)
    sums over the probes of y(li) / pdf where pdf > 0, each light's sample
    as scene/lights.py sample_li computes it (the light point and normal of
    a probe, which depend on the probe and the light only, computed once;
    the probes summed in order)."""
    n_s = halton.shape[0]
    ext = torch.as_tensor(vox_ext, device=vox_lo.device)
    pts = vox_lo[None] + (halton[:, None, :3] * ext)   # (S, C, 3)
    cols = []
    for j in range(lt.n_lights):
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


def grid_contrib(lt, vox_lo, vox_ext, halton):
    """K12 (plain version on CPU tensors): voxel corners (C, 3) and the
    voxel extent (3,) float32 numpy -> (C, n_lights) contribution sums."""
    if not cuda.use_kernel(vox_lo):
        return grid_contrib_plain(lt, vox_lo, vox_ext, halton)
    dev = vox_lo.device
    c, n_l, n_s = vox_lo.shape[0], lt.n_lights, halton.shape[0]
    cuda.check(vox_lo, "vox_lo", torch.float32, (c, 3), dev)
    cuda.check(halton, "halton", torch.float32, (n_s, 5), dev)
    cuda.check(lt.l_tri_p, "l_tri_p", torch.float32, (n_l, 3, 3), dev)
    cuda.check(lt.l_emit, "l_emit", torch.float32, (n_l, 3), dev)
    for t, name in ((lt.l_tri_rev, "l_tri_rev"),
                    (lt.l_twosided, "l_twosided")):
        cuda.check(t, name, torch.bool, (n_l,), dev)
    cuda.check(lt.l_area, "l_area", torch.float32, (n_l,), dev)
    out = torch.empty((c, n_l), dtype=torch.float32, device=dev)
    ext = [float(x) for x in np.asarray(vox_ext, np.float32)]
    if c:
        cuda.launch("spatial_grid_contrib", vox_lo, c, *ext, halton, n_s,
                    lt.l_tri_p, lt.l_tri_rev, lt.l_twosided, lt.l_emit,
                    lt.l_area, n_l, out)
    return out


def voxels(world_lo, world_hi, max_voxels: int = MAX_VOXELS):
    """The grid over the bounds: the widest axis gets ``max_voxels``
    voxels, the others in proportion. -> (nv (3,) int64, diag (3,),
    every voxel's lower corner (V, 3) in C order (flat = (ix*ny + iy)*nz
    + iz), the voxel extent (3,)), float32 numpy."""
    world_lo = np.asarray(world_lo, np.float32)
    world_hi = np.asarray(world_hi, np.float32)
    diag = np.maximum(world_hi - world_lo, 1e-6)
    b_max = float(diag.max())
    nv = np.maximum(1, np.round(diag / b_max * max_voxels)).astype(np.int64)
    coords = np.stack(np.meshgrid(np.arange(nv[0]), np.arange(nv[1]),
                                  np.arange(nv[2]), indexing="ij"),
                      -1).reshape(-1, 3).astype(np.float32)
    vox_ext = (diag / nv).astype(np.float32)
    return nv, diag, world_lo + coords * vox_ext, vox_ext


def build_spatial_grid(lt, world_lo, world_hi, max_voxels: int = MAX_VOXELS,
                       n_samples: int = N_SAMPLES,
                       chunk_voxels: int = CHUNK_VOXELS) -> SpatialLightGrid:
    """The full voxel grid of light-selection pmfs on ``lt``'s device, the
    voxels' contributions from K12 a chunk of ``chunk_voxels`` at a
    time."""
    dev = lt.l_emit.device
    world_lo = np.asarray(world_lo, np.float32)
    nv, diag, vox_lo, vox_ext = voxels(world_lo, world_hi, max_voxels)
    n_l = lt.n_lights
    halton = torch.as_tensor(_radical_inverse_table(n_samples), device=dev)
    rows = [grid_contrib(lt, torch.as_tensor(vox_lo[s:s + chunk_voxels],
                                             device=dev), vox_ext, halton)
            for s in range(0, vox_lo.shape[0], chunk_voxels)]
    contrib = torch.cat(rows, 0).cpu().numpy()   # (V, n_l)

    # floor so no light has zero probability
    avg = contrib.sum(-1, keepdims=True) / (n_samples * n_l)
    min_c = np.where(avg > 0.0, MIN_CONTRIB_FRAC * avg, 1.0)
    contrib = np.maximum(contrib, min_c)
    pmf = contrib / contrib.sum(-1, keepdims=True)
    cdf = np.cumsum(pmf, -1)
    cdf[:, -1] = 1.0

    strides = np.array([nv[1] * nv[2], nv[2], 1], np.int32)
    inv_ext = (1.0 / diag).astype(np.float32)
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
