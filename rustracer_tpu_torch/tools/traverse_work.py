"""K1's wavefronts on the matte dragon, the work the plain walk does on them,
and K1's bound; shared by chip_smoke.py and tools/bench_traverse.py.

The wavefronts (``wavefronts``) are the camera rays of the middle 2^18-lane
tile of the 1024^2 render (tile 2, floor and dragon), bounce rays from their
hits (seeded uniform directions in the hemisphere of the normal), and a
2^16-lane slab, the B/4 width the integrator compacts to: the bounce rays
of the top tile in alive-first order, whose dead lanes (camera misses)
carry t_max = 0.

K1's bound (``k1_bound``) is the larger of the bytes the call must move
over PEAK_BYTES_PER_S (the rays, 28 B in and 9 B out each, and every
distinct record read, 512 B) and its float operations over PEAK_OPS_PER_S
(16 slab tests of SLAB_OPS per interior record read, TRI_OPS per triangle
test), counted on the call's data by the plain walk (``k1_work``).
"""
from __future__ import annotations

import torch

from ..accel.traverse16 import traverse16, traverse16_plain
from ..core.math import normalize
from ..core.ray import Ray

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# operations a second outside the tensor cores: the data sheet's 67 TFLOP/s
# float32 counts an FMA as two; the kernels are built with -fmad=false, so
# each counted operation is one instruction, issued at half that rate
PEAK_OPS_PER_S = 67e12 / 2
# float32 operations of one slab test (6 subtractions and 6 products, 6
# min/max of the pairs, 4 to combine them, the t_far scale and 3 compares)
SLAB_OPS = 26
# ... and of one watertight triangle test (common.cuh tri_intersect: the
# set-up 12, the shear 24, the edge functions 27, signs and determinant 10,
# t 6, the error bound 41, the two compares 2)
TRI_OPS = 122
RAY_BYTES = 12 + 12 + 4 + 1 + 4 + 4   # o, d, t_max in; hit, t, prim out
RES = (1024, 1024)
LANES = 1 << 18
SLAB = 1 << 16


def wavefronts(ctx, cam, sampler, tiles, seed=1234):
    """-> {"camera", "bounce", "slab": Ray} (see the module docstring) of
    the matte dragon ``ctx`` rendered in ``tiles``."""
    from ..scene.tables import build_interaction

    def bounce_of(tile, gen):
        px, py, _ = tile
        pix = py.long() * RES[0] + px.long()
        smp = torch.full_like(pix, 3)
        p_film = torch.stack([px, py], -1).float() + sampler.get_2d(pix, smp,
                                                                    0)
        cam_ray = cam.generate_ray_differential(p_film)
        hit, t, tid = traverse16(ctx.geom, cam_ray.o, cam_ray.d,
                                 cam_ray.t_max, any_hit=False)
        prim = torch.where(hit, tid + ctx.geom.n_quadrics, 0)
        si = build_interaction(ctx.geom, cam_ray, hit, t, prim)
        w = normalize(torch.randn((px.shape[0], 3), generator=gen,
                                  device=px.device))
        w = torch.where(((w * si.n).sum(-1) < 0)[:, None], -w, w)
        b = si.spawn_ray(w)
        bounce = Ray(o=torch.where(si.valid[:, None], b.o, cam_ray.o),
                     d=w.contiguous(), t_max=b.t_max)
        return cam_ray, bounce, si.valid

    gen = torch.Generator(device=tiles[0][0].device)
    gen.manual_seed(seed)
    cam_ray, bounce, _ = bounce_of(tiles[len(tiles) // 2], gen)
    _, top, alive = bounce_of(tiles[0], gen)
    order = torch.argsort((~alive).int(), stable=True)[:SLAB]
    slab = Ray(o=top.o[order].contiguous(), d=top.d[order].contiguous(),
               t_max=torch.where(alive[order], top.t_max[order], 0.0))
    return {"camera": Ray(o=cam_ray.o, d=cam_ray.d, t_max=cam_ray.t_max),
            "bounce": bounce, "slab": slab}


class _CountedTable:
    """A record table that counts the reads of each row: the plain walk
    reads the table only as ``table.shape[0]`` and ``table[rows]``."""

    def __init__(self, table):
        self.table, self.shape = table, table.shape
        self.reads = torch.zeros(table.shape[0], dtype=torch.int64,
                                 device=table.device)

    def __getitem__(self, rows):
        self.reads.index_add_(0, rows, torch.ones_like(rows))
        return self.table[rows]


def k1_work(geom, ray, any_hit):
    """The plain walk on ``ray`` -> ((hit, t, prim, counts), work dict:
    rays, rows read, interior rows, leaf rows, triangle tests, distinct
    records)."""
    table = _CountedTable(geom.bvh16_table)
    out = traverse16_plain(table, geom.bvh16_roots, geom.bvh16_depth, ray.o,
                           ray.d, ray.t_max, any_hit)
    leaf = geom.bvh16_table[:, 0].view(torch.int32) < 0
    reads = table.reads
    work = dict(rays=ray.o.shape[0], rows=int(out[3][0]),
                tests=int(out[3][1]), interior_rows=int(reads[~leaf].sum()),
                leaf_rows=int(reads[leaf].sum()),
                distinct=int((reads > 0).sum()))
    return out, work


def k1_bound(work):
    """-> (bound ms, "bytes" or "operations") of a K1 call doing ``work``."""
    moved = work["rays"] * RAY_BYTES + work["distinct"] * 512
    ops = work["interior_rows"] * 16 * SLAB_OPS + work["tests"] * TRI_OPS
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def equal_outputs(a, b):
    """Bit equality of two (hit, t, prim, counts)."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
            and torch.equal(a[3].cpu(), b[3].cpu()))
