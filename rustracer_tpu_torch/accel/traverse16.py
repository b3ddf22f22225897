"""Closest-hit and any-hit traversal of the 16-wide BVH (port of
rustracer_tpu/accel/traverse16.py, without instancing) and its hand kernel
K1 (csrc/traverse16.cu).

Per-ray state: row, 16-bit visit mask, a stack of (row, remaining mask)
pairs of the table's depth, t_best and prim. One step reads one 128-float
record: an interior record gives 16 slab tests against t_best and descends
to the nearest unvisited hit child (children are pre-sorted per ray
octant), pushing the rest; a leaf record gives 8 watertight triangle tests;
otherwise the walk pops, and the popped record is read again and re-tested
against the tightened t_best. Any-hit stops at the first leaf hit.

``traverse16_plain`` is that walk in plain PyTorch over a batch of rays,
stepping only the live ones; the kernel runs the same walk with a group of
16 lanes per ray, persistent groups taking rays from a counter. Both return
(hit bool, t f32 (INF on a miss), prim int32 (0 on a miss)) and, when
asked, the observed work [rows read, triangle tests].
"""
from __future__ import annotations

import torch

from .. import cuda
from ..core.math import INFINITY
from ..ops.triangle import triangle_intersect_c

FULL_MASK = (1 << 16) - 1
MAX_DEPTH = 32   # the kernel's register stack (csrc/traverse16.cu kMaxDepth)
_RAY_COUNTERS = {}   # (device, stream) -> K1's ray counter, 0 between launches


def _ray_counter(dev):
    """K1's ray counter for the current stream of ``dev``: zeroed once;
    each launch leaves it at 0 for the next launch on that stream."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    counter = _RAY_COUNTERS.get(key)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _RAY_COUNTERS[key] = counter
    return counter


def _inv_dir(c):
    tiny = torch.where(c < 0, -1e-20, 1e-20).to(c.dtype)
    return 1.0 / torch.where(torch.abs(c) < 1e-20, tiny, c)


def _i32(x):
    return x.view(torch.int32)


def _interior_hits(rec, ray, t_best, vmask):
    """16 slab tests of interior records rec (n, 128) -> (bitmask (n,) of
    the unvisited hit children, links (n, 16), the 16 slot bits)."""
    ox, oy, oz, ix, iy, iz = (v[:, None] for v in ray)
    links = _i32(rec[:, 1:17])
    t0x = (rec[:, 17:33] - ox) * ix
    t1x = (rec[:, 65:81] - ox) * ix
    t0y = (rec[:, 33:49] - oy) * iy
    t1y = (rec[:, 81:97] - oy) * iy
    t0z = (rec[:, 49:65] - oz) * iz
    t1z = (rec[:, 97:113] - oz) * iz
    t_near = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                        torch.maximum(t0y, t1y)),
                          torch.maximum(t0z, t1z)) * 1.00000024
    box_hit = (t_near <= t_far) & (t_far > 0.0) & \
        (t_near < t_best[:, None]) & (links >= 0)
    bits = 1 << torch.arange(16, dtype=torch.int32, device=rec.device)
    m = torch.sum(torch.where(box_hit, bits, 0), dim=1, dtype=torch.int32)
    return m & vmask, links, bits


def _leaf_hits(rec, o, d, t_best):
    """8 watertight tests of leaf records -> (best tid or -1, its t,
    number of non-pad triangles)."""
    tid = _i32(rec[:, 1:9])                               # (n, 8)
    blk = [rec[:, 9 + 8 * j:17 + 8 * j] for j in range(9)]
    th = triangle_intersect_c(
        tuple(v[:, None] for v in o), tuple(v[:, None] for v in d),
        t_best[:, None], blk[0:3], blk[3:6], blk[6:9])
    ok = (tid >= 0) & th.hit
    t_cand = torch.where(ok, th.t, INFINITY)
    j = torch.argmin(t_cand, dim=1, keepdim=True)         # first on a tie
    best = torch.where(torch.gather(ok, 1, j), torch.gather(tid, 1, j), -1)
    return best[:, 0], torch.gather(t_cand, 1, j)[:, 0], \
        (tid >= 0).sum(1, dtype=torch.int32)


def traverse16_plain(table, roots, depth, o, d, t_max, any_hit: bool):
    """Plain PyTorch walk -> (hit, t, prim, counts int64 [rows, tests])."""
    dev = o.device
    R = table.shape[0]
    n = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    inv = (_inv_dir(dx), _inv_dir(dy), _inv_dir(dz))
    octant = ((dx < 0).int() | ((dy < 0).int() << 1) | ((dz < 0).int() << 2))
    row = roots.long()[octant.long()].int()
    vmask = torch.full((n,), FULL_MASK, dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int32, device=dev)
    t_best = t_max.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack_row = torch.zeros((n, max(depth, 1)), dtype=torch.int32, device=dev)
    stack_mask = torch.zeros_like(stack_row)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    live = torch.nonzero(~(t_max <= 0.0))[:, 0]           # dead lanes start done
    while live.numel():
        r, vm, s, tb, pr = row[live], vmask[live], sp[live], t_best[live], \
            prim[live]
        rec = table[r.clamp(0, R - 1).long()]
        is_leaf = _i32(rec[:, 0]) < 0
        ray_l = (ox[live], oy[live], oz[live])
        dir_l = (dx[live], dy[live], dz[live])
        m, links, bits = _interior_hits(
            rec, ray_l + tuple(v[live] for v in inv), tb, vm)
        best, t_min, n_tri = _leaf_hits(rec, ray_l, dir_l, tb)
        counts[0] += live.numel()
        counts[1] += torch.where(is_leaf, n_tri, 0).sum()
        upd = is_leaf & (best >= 0) & (t_min < tb)
        tb = torch.where(upd, t_min, tb)
        pr = torch.where(upd, best, pr)

        descend = ~is_leaf & (m != 0)
        low = m & -m
        link = torch.sum(torch.where((low[:, None] & bits) != 0, links, 0),
                         dim=1, dtype=torch.int32)
        rest = m & ~low
        push = descend & (rest != 0)
        at = push & (s < depth)
        sl = s.clamp(0, stack_row.shape[1] - 1).long()
        li = live[at]
        stack_row[li, sl[at]] = r[at]
        stack_mask[li, sl[at]] = rest[at]
        s = s + push.int()

        need_pop = ~descend
        top = (s - 1).clamp(0, stack_row.shape[1] - 1).long()
        in_stack = (s > 0) & (s - 1 < depth)
        prow = torch.where(in_stack, stack_row[live, top], 0)
        pmask = torch.where(in_stack, stack_mask[live, top], 0)
        can_pop = need_pop & (s > 0)
        done = need_pop & (s == 0)
        if any_hit:
            done = done | (pr >= 0)
        row[live] = torch.where(can_pop, prow, torch.where(descend, link, r))
        vmask[live] = torch.where(can_pop, pmask,
                                  torch.where(descend, FULL_MASK, vm))
        sp[live] = s - can_pop.int()
        t_best[live] = tb
        prim[live] = pr
        live = live[~done]
    hit = prim >= 0
    return hit, torch.where(hit, t_best, INFINITY), prim.clamp(min=0), counts


def traverse16(geom, o, d, t_max, any_hit: bool, with_counts: bool = False):
    """Wide-BVH traversal of the rays (o (B,3), d (B,3), t_max (B,)) against
    ``geom``'s table. CPU tensors take the plain version, CUDA tensors
    launch K1. -> (hit, t, prim) or, with_counts, (hit, t, prim, counts)."""
    if not cuda.use_kernel(o):
        out = traverse16_plain(geom.bvh16_table, geom.bvh16_roots,
                               geom.bvh16_depth, o, d, t_max, any_hit)
        return out if with_counts else out[:3]
    n = o.shape[0]
    dev = o.device
    cuda.check(o, "o", torch.float32, (n, 3), dev)
    cuda.check(d, "d", torch.float32, (n, 3), dev)
    cuda.check(t_max, "t_max", torch.float32, (n,), dev)
    table = geom.bvh16_table
    cuda.check(table, "bvh16_table", torch.float32, (table.shape[0], 128), dev)
    cuda.check(geom.bvh16_roots, "bvh16_roots", torch.int32, (8,), dev)
    if geom.bvh16_depth > MAX_DEPTH:
        raise ValueError(f"BVH depth {geom.bvh16_depth} exceeds the kernel's "
                         f"stack of {MAX_DEPTH}")
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev) if with_counts \
        else None
    if n:
        cuda.launch("traverse16_any" if any_hit else "traverse16_closest",
                    table, table.shape[0], geom.bvh16_roots,
                    geom.bvh16_depth, o, d, t_max, n, hit, t, prim,
                    counts, _ray_counter(dev))
    return (hit, t, prim, counts) if with_counts else (hit, t, prim)
