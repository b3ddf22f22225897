"""Host-side 16-wide BVH build (port of rustracer_tpu/accel/wide.py, the
single-tree path, over the native SAH builder of csrc/bvh_builder.cpp).

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

Rows [o*Ni, (o+1)*Ni) hold octant o's interior copy with children sorted
near-to-far along the octant's direction; the leaf block follows. The code
is the JAX package's, so both packages build the same bytes.
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


def build_binary_sah(lo, hi, max_prims):
    """Binary SAH tree over AABBs -> (nodes_lo, nodes_hi, meta, prims), DFS
    preorder: child1 = idx + 1, meta = [second child or prim offset,
    n_prims (0 for interiors), split axis]."""
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
        lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p), n, 0, max_prims,
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
                    nodes_lo, nodes_hi, leaf_row_of):
    """Write the 8 per-octant interior copies; returns the 8 root rows."""
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
            rec = table[o * Ni + wid]
            rec[0] = np.int32(k).view(np.float32)
            lk_off = np.where(interior[perm], links[perm] + o * Ni,
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
    return np.arange(8, dtype=np.int32) * Ni


def build_wide_arrays(tv_p, t_idx):
    """Triangle soup -> dict(bvh16_table (R, 128) f32, bvh16_roots (8,) i32,
    bvh16_depth int)."""
    tv_p = np.asarray(tv_p, np.float32)
    t_idx = np.asarray(t_idx)
    p = tv_p[t_idx]                                   # (T, 3, 3)
    lo = np.minimum(np.minimum(p[:, 0], p[:, 1]), p[:, 2])
    hi = np.maximum(np.maximum(p[:, 0], p[:, 1]), p[:, 2])
    nodes_lo, nodes_hi, meta, prims = build_binary_sah(lo, hi, LEAF_K)
    if meta[0, 1] > 0:         # a leaf-only tree gets a 1-child interior root
        wc, wl, wmap, depth = [[0]], [[True]], {0: 0}, 2
    else:
        wc, wl, wmap, depth = collapse_wide(meta)
    leaf_rows, binary_leaves = {}, []
    for kids, lfs in zip(wc, wl):
        for b, lf in zip(kids, lfs):
            if lf and b not in leaf_rows:
                leaf_rows[b] = len(binary_leaves)
                binary_leaves.append(b)
    tids = np.full((len(binary_leaves), LEAF_K), -1, np.int32)
    for j, b in enumerate(binary_leaves):
        off, cnt = int(meta[b, 0]), int(meta[b, 1])
        tids[j, :cnt] = prims[off:off + cnt]
    Ni = len(wc)
    leaf_base = 8 * Ni
    table = np.zeros((leaf_base + max(len(binary_leaves), 1), REC),
                     np.float32)
    roots = _fill_interiors(table, wc, wl, wmap, nodes_lo, nodes_hi,
                            lambda b: leaf_base + leaf_rows[b])
    table[leaf_base:leaf_base + len(binary_leaves)] = \
        _leaf_records(tids, tv_p, t_idx)
    return dict(bvh16_table=table, bvh16_roots=roots, bvh16_depth=depth)
