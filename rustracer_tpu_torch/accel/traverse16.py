"""Closest-hit and any-hit traversal of the 16-wide BVH (port of
rustracer_tpu/accel/traverse16.py) and its hand kernel K1
(csrc/traverse16.cu).

Per-ray state: row, 16-bit visit mask, a stack of (row, remaining mask)
pairs of the table's depth, t_best and prim. One step reads one 128-float
record: an interior record gives 16 slab tests against t_best and descends
to the nearest unvisited hit child (children are pre-sorted per ray
octant), pushing the rest; a leaf record gives 8 watertight triangle tests;
otherwise the walk pops, and the popped record is read again and re-tested
against the tightened t_best. Any-hit stops at the first leaf hit.

Instancing (``instanced``, the reference's TransformedPrimitive,
primitive.rs:89-118): an instance record (tag >= TAG_INST) moves the ray to
object space by the record's world-to-object rows (words 10-21, the
direction left unnormalised, so t stays the same parameter in both spaces)
and jumps to the root of the object's BLAS for the object ray's octant
(words 1-8); a pop below the stack height at entry restores the world ray.
The walk then also returns the instance of the hit (-1 for a static hit
and a miss).

Alpha cutouts (``alpha``, the reference's per-triangle test,
shapes/mesh.rs:355-367): a triangle of the leaf that passes the watertight
test and has an alpha id >= 0 in one of the given columns (closest hit:
``t_alpha_tex``; any hit: also ``t_shadow_alpha_tex``, mesh.rs:572-577)
takes its uv from the test's barycentrics and its t_shade uv words (the
default (0,0), (1,0), (1,1) without uv), bilerps the baked alpha atlas as
rustracer_tpu/scene/tables.py _alpha_at does, and is dropped where that is
0.0, before the leaf's minimum. The JAX package instead re-traces whole
walks from just past each cut-out hit; the filter departs from that loop
where the loop departs from the reference: the loop skips a surface within
rej_t * 1e-4 + 1e-5 behind a cut-out hit, and it gives up after 64
rejections. The filter does neither.

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
from .bvh_build import TAG_INST

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


def alpha_at(atlas, meta, aid, u, v):
    """Bilinear lookup (REPEAT wrap) of the baked alpha atlas at (u, v) of
    alpha maps ``aid`` >= 0 (rustracer_tpu/scene/tables.py _alpha_at)."""
    m = meta[aid.long()]
    off, w, h = m[..., 0], m[..., 1].clamp(min=1), m[..., 2].clamp(min=1)
    uu = u * w.float() - 0.5
    vv = v * h.float() - 0.5
    u0, v0 = torch.floor(uu), torch.floor(vv)
    du, dv = uu - u0, vv - v0
    u0, v0 = u0.int(), v0.int()

    def texel(ui, vi):
        # a floor modulo, never negative (torch's % on integers is one)
        return atlas[(off + (vi % h) * w + ui % w).long()]

    return (texel(u0, v0) * (1 - du) * (1 - dv)
            + texel(u0 + 1, v0) * du * (1 - dv)
            + texel(u0, v0 + 1) * (1 - du) * dv
            + texel(u0 + 1, v0 + 1) * du * dv)


def _cut_out(alpha, tid, th, ok):
    """(n, 8) bool: of the hits ``ok`` of triangles ``tid`` (the test
    ``th``), those in a cut-out of one of alpha's columns (alpha =
    (t_shade, columns, atlas, meta)). As K1, a hit reads its alpha ids,
    and only a hit with an id >= 0 its uv words and that map."""
    t_shade, cols, atlas, meta = alpha
    cut = torch.zeros_like(ok)
    lane, j = torch.nonzero(ok, as_tuple=True)
    t = tid[lane, j].long()
    aids = [col[t] for col in cols]
    sel = torch.nonzero(torch.stack([a >= 0 for a in aids]).any(0))[:, 0]
    if sel.numel() == 0:
        return cut
    lane, j, t = lane[sel], j[sel], t[sel]
    b0, b1, b2 = th.b0[lane, j], th.b1[lane, j], th.b2[lane, j]
    rows = t_shade[t]
    has_uv = (rows[:, 24].view(torch.int32) & 1) != 0
    one, zero = torch.ones_like(b0), torch.zeros_like(b0)
    uv = [torch.where(has_uv, rows[:, 18 + k], dflt)
          for k, dflt in enumerate((zero, zero, one, zero, one, one))]
    u = b0 * uv[0] + b1 * uv[2] + b2 * uv[4]
    v = b0 * uv[1] + b1 * uv[3] + b2 * uv[5]
    c = torch.zeros_like(has_uv)
    for aid in aids:
        aid = aid[sel]
        on = torch.nonzero(aid >= 0)[:, 0]
        c[on] |= alpha_at(atlas, meta, aid[on], u[on], v[on]) == 0.0
    cut[lane, j] = c
    return cut


def _leaf_hits(rec, o, d, t_best, alpha=None, is_leaf=None):
    """8 watertight tests of leaf records, cut-out hits dropped where
    ``alpha`` is given (on the records ``is_leaf``) -> (best tid or -1, its
    t, number of non-pad triangles)."""
    tid = _i32(rec[:, 1:9])                               # (n, 8)
    blk = [rec[:, 9 + 8 * j:17 + 8 * j] for j in range(9)]
    th = triangle_intersect_c(
        tuple(v[:, None] for v in o), tuple(v[:, None] for v in d),
        t_best[:, None], blk[0:3], blk[3:6], blk[6:9])
    ok = (tid >= 0) & th.hit
    if alpha is not None:
        ok = ok & ~_cut_out(alpha, tid, th, ok & is_leaf[:, None])
    t_cand = torch.where(ok, th.t, INFINITY)
    j = torch.argmin(t_cand, dim=1, keepdim=True)         # first on a tie
    best = torch.where(torch.gather(ok, 1, j), torch.gather(tid, 1, j), -1)
    return best[:, 0], torch.gather(t_cand, 1, j)[:, 0], \
        (tid >= 0).sum(1, dtype=torch.int32)


def traverse16_plain(table, roots, depth, o, d, t_max, any_hit: bool,
                     instanced: bool = False, alpha=None):
    """Plain PyTorch walk -> (hit, t, prim, counts int64 [rows, tests],
    inst (-1 for a static hit and a miss; all -1 unless ``instanced``)).
    ``alpha``: None, or (t_shade, the alpha columns to test, atlas, meta)."""
    dev = o.device
    R = table.shape[0]
    n = o.shape[0]
    world = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    world += [_inv_dir(c) for c in world[3:]]
    ray = [c.clone() for c in world]      # the ray in the current space
    octant = ((world[3] < 0).int() | ((world[4] < 0).int() << 1)
              | ((world[5] < 0).int() << 2))
    row = roots.long()[octant.long()].int()
    vmask = torch.full((n,), FULL_MASK, dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int32, device=dev)
    t_best = t_max.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst_cur = torch.full_like(prim, -1)
    inst_sp = torch.zeros_like(sp)
    inst_best = torch.full_like(prim, -1)
    stack_row = torch.zeros((n, max(depth, 1)), dtype=torch.int32, device=dev)
    stack_mask = torch.zeros_like(stack_row)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    live = torch.nonzero(~(t_max <= 0.0))[:, 0]           # dead lanes start done
    while live.numel():
        r, vm, s, tb, pr = row[live], vmask[live], sp[live], t_best[live], \
            prim[live]
        rc = [c[live] for c in ray]
        rec = table[r.clamp(0, R - 1).long()]
        tag = _i32(rec[:, 0])
        is_leaf = tag < 0
        enter = (tag >= TAG_INST) if instanced else torch.zeros_like(is_leaf)
        m, links, bits = _interior_hits(rec, rc[0:3] + rc[6:9], tb, vm)
        best, t_min, n_tri = _leaf_hits(rec, rc[0:3], rc[3:6], tb, alpha,
                                        is_leaf)
        counts[0] += live.numel()
        counts[1] += torch.where(is_leaf, n_tri, 0).sum()
        upd = is_leaf & (best >= 0) & (t_min < tb)
        tb = torch.where(upd, t_min, tb)
        pr = torch.where(upd, best, pr)

        descend = ~is_leaf & ~enter & (m != 0)
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

        need_pop = ~descend & ~enter
        top = (s - 1).clamp(0, stack_row.shape[1] - 1).long()
        in_stack = (s > 0) & (s - 1 < depth)
        prow = torch.where(in_stack, stack_row[live, top], 0)
        pmask = torch.where(in_stack, stack_mask[live, top], 0)
        can_pop = need_pop & (s > 0)
        done = need_pop & (s == 0)
        if any_hit:
            done = done | (pr >= 0)
        r_next = torch.where(can_pop, prow, torch.where(descend, link, r))
        vm_next = torch.where(can_pop, pmask,
                              torch.where(descend, FULL_MASK, vm))
        if instanced:
            ic, isp = inst_cur[live], inst_sp[live]
            inst_best[live] = torch.where(upd, ic, inst_best[live])
            # entry: the object ray by the record's w2o rows, in the
            # reference's order m0*x + m1*y + m2*z (+ m3)
            mm = [rec[:, 10 + k] for k in range(12)]
            wc = [c[live] for c in world]
            obj = [mm[4 * k] * wc[0] + mm[4 * k + 1] * wc[1]
                   + mm[4 * k + 2] * wc[2] + mm[4 * k + 3] for k in range(3)]
            obj += [mm[4 * k] * wc[3] + mm[4 * k + 1] * wc[4]
                    + mm[4 * k + 2] * wc[5] for k in range(3)]
            obj += [_inv_dir(c) for c in obj[3:]]
            oct_o = ((obj[3] < 0).long() | ((obj[4] < 0).long() << 1)
                     | ((obj[5] < 0).long() << 2))
            blas_root = torch.gather(_i32(rec[:, 1:9]), 1,
                                     oct_o[:, None])[:, 0]
            r_next = torch.where(enter, blas_root, r_next)
            vm_next = torch.where(enter, FULL_MASK, vm_next)
            # a pop below the entry height leaves the object
            exit_i = can_pop & (ic >= 0) & (s - 1 < isp)
            ic = torch.where(enter, _i32(rec[:, 9]),
                             torch.where(exit_i, -1, ic))
            inst_sp[live] = torch.where(enter, s, isp)
            inst_cur[live] = ic
            in_obj = ic >= 0
            for k in range(9):
                ray[k][live] = torch.where(
                    enter, obj[k], torch.where(in_obj, rc[k], wc[k]))
        row[live] = r_next
        vmask[live] = vm_next
        sp[live] = s - can_pop.int()
        t_best[live] = tb
        prim[live] = pr
        live = live[~done]
    hit = prim >= 0
    return (hit, torch.where(hit, t_best, INFINITY), prim.clamp(min=0),
            counts, torch.where(hit, inst_best, -1))


def k1_entry(geom, any_hit: bool) -> str:
    """The C entry point of K1 that walks ``geom``'s table: the plain walk,
    or the instanced, alpha or instanced-alpha one."""
    return ("traverse16_" + ("inst_" if geom.has_instances else "")
            + ("alpha_" if geom.has_alpha else "")
            + ("any" if any_hit else "closest"))


def alpha_tables(geom, any_hit: bool):
    """(t_shade, the alpha columns a closest (alpha) or any (alpha and
    shadow alpha) hit tests, atlas, meta), or None without alpha maps."""
    if not geom.has_alpha:
        return None
    cols = (geom.t_alpha_tex,) + ((geom.t_shadow_alpha_tex,) if any_hit
                                  else ())
    return geom.t_shade, cols, geom.alpha_atlas, geom.alpha_meta


def traverse16(geom, o, d, t_max, any_hit: bool, with_counts: bool = False,
               with_inst: bool = False):
    """Wide-BVH traversal of the rays (o (B,3), d (B,3), t_max (B,)) against
    ``geom``'s table (its instances and alpha maps honoured). CPU tensors
    take the plain version, CUDA tensors launch K1 (``k1_entry``).
    -> (hit, t, prim), then inst (-1 for a static hit and a miss) if
    ``with_inst``, then counts if ``with_counts``."""
    def out(hit, t, prim, counts, inst):
        return (hit, t, prim) + ((inst,) if with_inst else ()) + \
            ((counts,) if with_counts else ())
    alpha = alpha_tables(geom, any_hit)
    if not cuda.use_kernel(o):
        return out(*traverse16_plain(
            geom.bvh16_table, geom.bvh16_roots, geom.bvh16_depth, o, d,
            t_max, any_hit, geom.has_instances, alpha))
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
    name = k1_entry(geom, any_hit)
    if name in ("traverse16_closest", "traverse16_any"):
        inst = torch.full((n,), -1, dtype=torch.int32, device=dev) \
            if with_inst else None
        if n:
            cuda.launch(name, table, table.shape[0], geom.bvh16_roots,
                        geom.bvh16_depth, o, d, t_max, n, hit, t, prim,
                        counts, _ray_counter(dev))
        return out(hit, t, prim, counts, inst)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    if alpha is not None:
        t_shade, cols, atlas, meta = alpha
        nt = t_shade.shape[0]
        cuda.check(t_shade, "t_shade", torch.float32, (nt, 32), dev)
        for c, col in zip(("t_alpha_tex", "t_shadow_alpha_tex"), cols):
            cuda.check(col, c, torch.int32, (nt,), dev)
        cuda.check(atlas, "alpha_atlas", torch.float32, (atlas.shape[0],), dev)
        cuda.check(meta, "alpha_meta", torch.int32, (meta.shape[0], 3), dev)
        args = (t_shade, cols[0], cols[-1] if any_hit else None, atlas, meta)
    else:
        args = (None,) * 5
    if n:
        cuda.launch(name, table, table.shape[0], geom.bvh16_roots,
                    geom.bvh16_depth, o, d, t_max, n, hit, t, prim, inst,
                    counts, _ray_counter(dev), *args)
    return out(hit, t, prim, counts, inst)
