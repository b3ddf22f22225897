"""Host-side 16-wide BVH build (port of rustracer_tpu/accel/wide.py over
the native builder of csrc/bvh_builder.cpp: the SAH split, or the middle
split for the ``"middle"`` split method; every other name is SAH, as the
JAX package's native builder takes it).

The binary SAH tree is collapsed to 16-wide interiors with 8-triangle
leaves and packed into the unified (R, 128) float32 record table that
kernel K1 walks:

  interior record (0 <= tag <= 16, tag = n_children):
    [0] tag | [1..17) 16 child row links (int32 bits, -1 empty), pre-offset
    into the octant copy for interior children, absolute for leaves |
    [17..113) child AABBs component-major lo_x lo_y lo_z hi_x hi_y hi_z
    (empty slots +inf/-inf)
  leaf record (tag < 0, -tag = n_tris <= 8):
    [0] tag | [1..9) triangle ids (int32 bits, -1 pads) | [9..81) vertices
    component-major p0x[8] p0y[8] ... p2z[8] (pads are zeros, never hit)
  instance record (tag >= TAG_INST; the reference's TransformedPrimitive,
  primitive.rs:89-118):
    [0] tag | [1..9) the object's 8 per-octant BLAS root rows (int32 bits)
    | [9] instance id | [10..22) world-to-object rows 0-2, row-major

Rows [o*Ni, (o+1)*Ni) hold octant o's interior copy with children sorted
near-to-far along the octant's direction; the leaf block follows. An
instanced scene (``build_wide_scene``) is two levels: a root over the static
triangles' tree and a tree of instance records, then each object's BLAS
(its own 8 octant copies and leaves, over object-space bounds) once,
entered through the instance records. The code is the JAX package's, so
both packages build the same bytes.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import CSRC, compile_shared

WIDTH = 16        # children per interior node
LEAF_K = 8        # triangles per leaf record
REC = 128         # floats per record row
TAG_INST = 1 << 20   # the tag of an instance record
# the flags of the JAX package's build of the same source
GXX_COMMAND = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _native():
    global _lib
    with _lock:
        if _lib is None:
            path = compile_shared(
                "bvh_builder", [os.path.join(CSRC, "bvh_builder.cpp")],
                GXX_COMMAND, timeout=120)
            lib = ctypes.CDLL(path)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.build_bvh_sah.restype = ctypes.c_int32
            lib.build_bvh_sah.argtypes = [f32p, f32p, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32,
                                          f32p, f32p, i32p, i32p]
            _lib = lib
        return _lib


def split_code(split_method: str) -> int:
    """The native builder's split: 1 for "middle", 0 (SAH) for every other
    name ("sah", "hlbvh", "equal", ...)."""
    return 1 if split_method == "middle" else 0


def build_binary_sah(lo, hi, max_prims, split_method="sah"):
    """Binary tree over AABBs (SAH, or the middle split) -> (nodes_lo,
    nodes_hi, meta, prims), DFS preorder: child1 = idx + 1, meta = [second
    child or prim offset, n_prims (0 for interiors), split axis]."""
    lib = _native()
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    cap = 2 * n
    nodes_lo = np.empty((cap, 3), np.float32)
    nodes_hi = np.empty((cap, 3), np.float32)
    meta = np.empty((cap, 3), np.int32)
    prims = np.empty(n, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.build_bvh_sah(
        lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p), n,
        split_code(split_method), max_prims,
        nodes_lo.ctypes.data_as(f32p), nodes_hi.ctypes.data_as(f32p),
        meta.ctypes.data_as(i32p), prims.ctypes.data_as(i32p))
    if n_nodes <= 0:
        raise RuntimeError(f"native SAH build failed ({n_nodes})")
    return (nodes_lo[:n_nodes].copy(), nodes_hi[:n_nodes].copy(),
            meta[:n_nodes].copy(), prims)


def collapse_wide(meta):
    """Binary tree -> wide tree: (wide_children, wide_child_leaf,
    wide_of_binary, depth). A small subtree is absorbed whole when its
    leaves fit the remaining slots (smallest first), else the largest
    subtree is split, until 16 children."""
    is_leaf = meta[:, 1] > 0
    c2 = meta[:, 0]
    n = meta.shape[0]
    leaf_cnt = np.where(is_leaf, 1, 0).astype(np.int64)
    for i in range(n - 1, -1, -1):
        if not is_leaf[i]:
            leaf_cnt[i] = leaf_cnt[i + 1] + leaf_cnt[c2[i]]

    wide_children, wide_child_leaf = [], []
    todo = [0]
    wide_of_binary = {}
    depth_of = {0: 0}
    max_depth = 0
    while todo:
        b = todo.pop()
        if b in wide_of_binary:
            continue
        wide_of_binary[b] = len(wide_children)
        kids = [int(b) + 1, int(c2[b])]
        while len(kids) < WIDTH:
            room = WIDTH - (len(kids) - 1)
            best, best_c = -1, None
            for i, k in enumerate(kids):
                if not is_leaf[k] and leaf_cnt[k] <= room and (
                        best_c is None or leaf_cnt[k] < best_c):
                    best, best_c = i, leaf_cnt[k]
            if best < 0:
                for i, k in enumerate(kids):
                    if not is_leaf[k] and (best_c is None
                                           or leaf_cnt[k] > best_c):
                        best, best_c = i, leaf_cnt[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend([k + 1, int(c2[k])])
        wide_children.append(kids)
        wide_child_leaf.append([bool(is_leaf[k]) for k in kids])
        d = depth_of[b] + 1
        for k, lf in zip(kids, wide_child_leaf[-1]):
            if not lf:
                todo.append(k)
                depth_of[k] = d
                max_depth = max(max_depth, d)
    return wide_children, wide_child_leaf, wide_of_binary, max_depth + 1


def _leaf_records(tids, tv_p, t_idx):
    """(L, 8) padded triangle ids -> (L, REC) leaf records."""
    rec = np.zeros((tids.shape[0], REC), np.float32)
    if tids.shape[0] == 0:
        return rec
    rec[:, 0] = (-(tids >= 0).sum(1).astype(np.int32)).view(np.float32)
    rec[:, 1:9] = tids.view(np.float32)
    verts = tv_p[t_idx[np.maximum(tids, 0)]].astype(np.float32)  # (L,8,3,3)
    verts[tids < 0] = 0.0
    for v in range(3):
        for c in range(3):
            blk = 9 + (v * 3 + c) * 8
            rec[:, blk:blk + 8] = verts[:, :, v, c]
    return rec


_SIGNS = np.array([[1 - 2 * ((o >> a) & 1) for a in range(3)]
                   for o in range(8)], np.float32)   # (8, 3) octant dirs


def _fill_interiors(table, wide_children, wide_child_leaf, wide_map,
                    nodes_lo, nodes_hi, leaf_row_of, row_base=0):
    """Write the 8 per-octant interior copies at rows [row_base, row_base +
    8 Ni); returns the 8 root rows."""
    Ni = len(wide_children)
    INF = np.float32(np.inf)
    for wid, (kids, lfs) in enumerate(zip(wide_children, wide_child_leaf)):
        k = len(kids)
        klo = nodes_lo[kids]
        khi = nodes_hi[kids]
        cent = 0.5 * (klo + khi)
        links = np.array([leaf_row_of(b) if lf else wide_map[b]
                          for b, lf in zip(kids, lfs)], np.int32)
        interior = ~np.array(lfs, bool)
        for o in range(8):
            perm = np.argsort(cent @ _SIGNS[o], kind="stable")
            rec = table[row_base + o * Ni + wid]
            rec[0] = np.int32(k).view(np.float32)
            lk_off = np.where(interior[perm], links[perm] + row_base + o * Ni,
                              links[perm]).astype(np.int32)
            lnk = np.full(WIDTH, -1, np.int32)
            lnk[:k] = lk_off
            rec[1:17] = lnk.view(np.float32)
            box = np.empty((6, WIDTH), np.float32)
            box[0:3, :] = INF
            box[3:6, :] = -INF
            box[0:3, :k] = klo[perm].T
            box[3:6, :k] = khi[perm].T
            rec[17:113] = box.reshape(-1)
    return row_base + np.arange(8, dtype=np.int32) * Ni


def triangle_bounds(tv_p, t_idx):
    """Per-triangle AABBs -> (lo (T, 3), hi (T, 3))."""
    p = tv_p[t_idx]                                   # (T, 3, 3)
    return (np.minimum(np.minimum(p[:, 0], p[:, 1]), p[:, 2]),
            np.maximum(np.maximum(p[:, 0], p[:, 1]), p[:, 2]))


def _collapse_or_wrap(meta):
    """collapse_wide; a leaf-only tree gets a 1-child interior root."""
    if meta[0, 1] > 0:
        return [[0]], [[True]], {0: 0}, 2
    return collapse_wide(meta)


def _collect_leaves(wc, wl):
    """-> ({binary leaf: its index}, binary leaves in first-seen order)."""
    rows, order = {}, []
    for kids, lfs in zip(wc, wl):
        for b, lf in zip(kids, lfs):
            if lf and b not in rows:
                rows[b] = len(order)
                order.append(b)
    return rows, order


def _gather_leaf_tris(meta, prims, binary_leaves):
    """Binary leaf ids -> (L, 8) triangle ids, -1 padded."""
    tids = np.full((len(binary_leaves), LEAF_K), -1, np.int32)
    for j, b in enumerate(binary_leaves):
        off, cnt = int(meta[b, 0]), int(meta[b, 1])
        tids[j, :cnt] = prims[off:off + cnt]
    return tids


def identity_instances():
    """The instance tables of a scene without instances: one identity row
    (``GeometryTables.has_instances`` is False for it)."""
    return dict(inst_o2w=np.eye(4, dtype=np.float32)[None],
                inst_w2o=np.eye(4, dtype=np.float32)[None],
                inst_flip=np.zeros(1, bool))


def build_wide_arrays(tv_p, t_idx, split_method="sah"):
    """Triangle soup -> dict(bvh16_table (R, 128) f32, bvh16_roots (8,) i32,
    bvh16_depth int)."""
    tv_p = np.asarray(tv_p, np.float32)
    t_idx = np.asarray(t_idx)
    nodes_lo, nodes_hi, meta, prims = build_binary_sah(
        *triangle_bounds(tv_p, t_idx), LEAF_K, split_method)
    wc, wl, wmap, depth = _collapse_or_wrap(meta)
    leaf_rows, binary_leaves = _collect_leaves(wc, wl)
    tids = _gather_leaf_tris(meta, prims, binary_leaves)
    Ni = len(wc)
    leaf_base = 8 * Ni
    table = np.zeros((leaf_base + max(len(binary_leaves), 1), REC),
                     np.float32)
    roots = _fill_interiors(table, wc, wl, wmap, nodes_lo, nodes_hi,
                            lambda b: leaf_base + leaf_rows[b])
    table[leaf_base:leaf_base + len(binary_leaves)] = \
        _leaf_records(tids, tv_p, t_idx)
    return dict(bvh16_table=table, bvh16_roots=roots, bvh16_depth=depth)


def xform_aabb(o2w, lo, hi):
    """World AABB of an object-space AABB under a 4x4 affine transform."""
    cs = np.array([[x, y, z] for x in (lo[0], hi[0])
                   for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                  np.float32)
    w = cs @ o2w[:3, :3].T + o2w[:3, 3]
    return w.min(0), w.max(0)


def _interior_record(rec, links, lo, hi):
    """An interior record of len(links) children with bounds lo, hi (k, 3)."""
    k = len(links)
    rec[0] = np.int32(k).view(np.float32)
    lnk = np.full(WIDTH, -1, np.int32)
    lnk[:k] = links
    rec[1:17] = lnk.view(np.float32)
    box = np.empty((6, WIDTH), np.float32)
    box[0:3, :] = np.float32(np.inf)
    box[3:6, :] = -np.float32(np.inf)
    box[0:3, :k] = np.asarray(lo).T
    box[3:6, :k] = np.asarray(hi).T
    rec[17:113] = box.reshape(-1)


def build_wide_scene(tris, objects, instances, split_method="sah"):
    """Two-level wide BVH of an instanced scene (rustracer_tpu/accel/wide.py
    build_wide_scene).

    tris: the whole triangle dict, static world-space triangles first (rows
      [0, n_static)), then each object's object-space triangles.
    objects: (tri_lo, tri_hi) row ranges, one per instanced object.
    instances: dicts {obj, o2w (4, 4), w2o (4, 4), flip}.

    -> bvh16_table, bvh16_roots, bvh16_depth and the inst_o2w, inst_w2o,
    inst_flip tables (a single instance padded with an identity row, so
    that ``has_instances``, a count of rows > 1, holds)."""
    tv_p = np.asarray(tris["tv_p"], np.float32)
    t_idx = np.asarray(tris["t_idx"])
    n_static = objects[0][0] if objects else t_idx.shape[0]

    def tree(lo, hi, max_prims):
        nl, nh, meta, prims = build_binary_sah(lo, hi, max_prims,
                                               split_method)
        wc, wl, wmap, dep = _collapse_or_wrap(meta)
        return dict(nl=nl, nh=nh, meta=meta, prims=prims, wc=wc, wl=wl,
                    wmap=wmap, depth=dep)

    # each object's BLAS over its object-space triangles
    blas = []
    for alo, ahi in objects:
        b = tree(*triangle_bounds(tv_p, t_idx[alo:ahi]), LEAF_K)
        b["prims"] = b["prims"] + alo               # global triangle ids
        blas.append(b)

    # instance tables and world AABBs
    n_inst = len(instances)
    eye = np.eye(4, dtype=np.float32)[None]
    inst_o2w = np.stack([np.asarray(r["o2w"], np.float32)
                         for r in instances]) if n_inst else eye
    inst_w2o = np.stack([np.asarray(r["w2o"], np.float32)
                         for r in instances]) if n_inst else eye
    inst_flip = np.array([bool(r.get("flip", False)) for r in instances],
                         bool) if n_inst else np.zeros(1, bool)
    ilo = np.empty((n_inst, 3), np.float32)
    ihi = np.empty((n_inst, 3), np.float32)
    for i, r in enumerate(instances):
        b = blas[r["obj"]]
        ilo[i], ihi[i] = xform_aabb(inst_o2w[i], b["nl"][0], b["nh"][0])

    # the instance tree: each binary leaf is one instance record
    itree = tree(ilo, ihi, 1)
    stree = tree(*triangle_bounds(tv_p, t_idx[:n_static]), LEAF_K) \
        if n_static > 0 else None

    # rows: [root 8][static interiors 8 Ns][instance interiors 8 Nv]
    # [static leaves][instance records][per object: 8 Ni interiors, leaves]
    static_base = 8
    itree_base = static_base + (8 * len(stree["wc"]) if stree else 0)
    cursor = itree_base + 8 * len(itree["wc"])
    if stree:
        sleaf_rows, sleaves = _collect_leaves(stree["wc"], stree["wl"])
        static_leaf_base = cursor
        cursor += len(sleaves)
    ileaf_rows, ileaves = _collect_leaves(itree["wc"], itree["wl"])
    inst_rec_base = cursor
    cursor += len(ileaves)
    for b in blas:
        b["leaf_rows"], b["leaves"] = _collect_leaves(b["wc"], b["wl"])
        b["base"] = cursor
        cursor += 8 * len(b["wc"])
        b["leaf_base"] = cursor
        cursor += len(b["leaves"])
    table = np.zeros((max(cursor, 2), REC), np.float32)

    for b in blas:
        b["roots8"] = _fill_interiors(
            table, b["wc"], b["wl"], b["wmap"], b["nl"], b["nh"],
            lambda bb, _b=b: _b["leaf_base"] + _b["leaf_rows"][bb], b["base"])
        tids = _gather_leaf_tris(b["meta"], b["prims"], b["leaves"])
        table[b["leaf_base"]:b["leaf_base"] + len(b["leaves"])] = \
            _leaf_records(tids, tv_p, t_idx)

    for j, b_leaf in enumerate(ileaves):
        off, cnt = int(itree["meta"][b_leaf, 0]), int(itree["meta"][b_leaf, 1])
        assert cnt == 1
        i = int(itree["prims"][off])
        rec = table[inst_rec_base + j]
        rec[0] = np.int32(TAG_INST).view(np.float32)
        rec[1:9] = blas[instances[i]["obj"]]["roots8"].view(np.float32)
        rec[9] = np.int32(i).view(np.float32)
        rec[10:22] = inst_w2o[i][:3, :].reshape(-1)

    iroots = _fill_interiors(table, itree["wc"], itree["wl"], itree["wmap"],
                             itree["nl"], itree["nh"],
                             lambda b: inst_rec_base + ileaf_rows[b],
                             itree_base)
    kids_lo, kids_hi = [itree["nl"][0]], [itree["nh"][0]]
    if stree:
        sroots = _fill_interiors(table, stree["wc"], stree["wl"],
                                 stree["wmap"], stree["nl"], stree["nh"],
                                 lambda b: static_leaf_base + sleaf_rows[b],
                                 static_base)
        stids = _gather_leaf_tris(stree["meta"], stree["prims"], sleaves)
        table[static_leaf_base:static_leaf_base + len(sleaves)] = \
            _leaf_records(stids, tv_p, t_idx)
        kids_lo.append(stree["nl"][0])
        kids_hi.append(stree["nh"][0])

    # the root: one interior of 1-2 children a octant, rows 0-7
    for o in range(8):
        links = [int(iroots[o])] + ([int(sroots[o])] if stree else [])
        _interior_record(table[o], links, np.stack(kids_lo),
                         np.stack(kids_hi))

    max_blas = max((b["depth"] for b in blas), default=0)
    depth = max(stree["depth"] if stree else 0,
                itree["depth"] + max_blas) + 2
    if inst_o2w.shape[0] < 2:
        inst_o2w = np.concatenate([inst_o2w, eye])
        inst_w2o = np.concatenate([inst_w2o, eye])
        inst_flip = np.concatenate([inst_flip, np.zeros(1, bool)])
    return dict(bvh16_table=table, bvh16_roots=np.arange(8, dtype=np.int32),
                bvh16_depth=int(depth), inst_o2w=inst_o2w, inst_w2o=inst_w2o,
                inst_flip=inst_flip)
