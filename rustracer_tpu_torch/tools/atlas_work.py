"""The work one K5 call (the atlas EWA lookup) needs, and its bound; shared by
chip_smoke.py and tools/bench_step_kernels.py.

Only the textured lanes (reg >= 0) need a lookup; the others need their
registration read and a zero written. ``k5_work`` counts, with the plain
version's own arithmetic (scene/atlas.py), what the call's inputs need:

- operations: K5_LANE_OPS for each textured lane;
- bytes: every lane's registration (4 B) and (3,) output (12 B), each
  textured lane's uv and four differentials (24 B), and each distinct quad
  row (48 B) or texel (12 B) the textured lanes' lookups read, counted
  once (the registration and level tables are a few hundred bytes and are
  left out).

``k5_bound`` turns that into the least time the card could take: the larger
of the bytes over PEAK_BYTES_PER_S and the operations over PEAK_OPS_PER_S
(tools/traverse_work.py).

K10, the lookup's backward, needs the same lanes' inputs and their (B, 3)
gradient, writes the (T, 3) texel gradient once and does K10_LANE_OPS for
each textured lane (``k10_work``, ``k5_bound``). ``k10_atomics`` counts
the global atomics that its designs issue for one call, and the adds that
land on the busiest texel.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..ops.mipmap import WRAP_BLACK, WRAP_REPEAT
from ..scene import atlas as A
from .traverse_work import PEAK_BYTES_PER_S, PEAK_OPS_PER_S

# operations of one lookup, each one instruction in a build without FMAs:
# the set-up (registration, st, the two axes, the level; about 50) and 16
# bilinear taps (weights and the three channels' blend, about 25 each)
K5_LANE_OPS = 450
LANE_BYTES = 4 + 12          # reg in, (3,) float32 out: every lane
TEXTURED_LANE_BYTES = 8 + 16  # uv and the four differentials: textured lanes
QUAD_ROW_BYTES = 48
TEXEL_BYTES = 12
# operations a textured lane of K10 does: K5's set-up (about 60), then for
# 8 taps x 2 levels the bilinear set-up (12) and 4 corners of a weight (3),
# its product with the lane's 3 gradients and the address (10)
K10_LANE_OPS = 60 + 16 * (12 + 4 * 13)
# the (B, 3) gradient in: textured lanes
K10_LANE_BYTES = 12
# K10's layout (csrc/atlas_bwd.cu): lanes a tile, threads a block; the
# earlier kernel ran one thread a lane, 32 lanes a warp
K10_TILE = 1024
K10_THREADS = 256


def _texel_index(off, w, h, wrap, s_i, t_i):
    """-> (texel index, read) of _texel_at: WRAP_BLACK reads nothing outside
    the level."""
    rep = wrap == WRAP_REPEAT
    s_f = torch.where(rep, torch.remainder(s_i, w),
                      torch.minimum(torch.clamp(s_i, min=0), w - 1))
    t_f = torch.where(rep, torch.remainder(t_i, h),
                      torch.minimum(torch.clamp(t_i, min=0), h - 1))
    inside = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
    return (off + t_f * w + s_f).long(), ~((wrap == WRAP_BLACK) & ~inside)


def k5_rows(meta, levels, regs, reg, si, quad):
    """Distinct quad rows (``quad``) or texels read by the lookups of the
    textured lanes of one call -> 1-D int64 tensor, sorted."""
    sel = reg >= 0
    if not bool(sel.any()):
        return torch.zeros(0, dtype=torch.int64, device=reg.device)
    sub = SimpleNamespace(uv=si.uv[sel], dudx=si.dudx[sel],
                          dvdx=si.dvdx[sel], dudy=si.dudy[sel],
                          dvdy=si.dvdy[sel])
    _, img, wrap, st, major, minor_len = A._ewa_axes(regs, reg[sel], sub)
    level, big_l = A.ewa_level(levels, img, minor_len)
    l0 = torch.floor(level).int()
    l1 = torch.minimum(l0 + 1, big_l - 1)
    rows = []
    for a, _ in A.TAPS:
        st_k = st + a * major
        for li in (l0, l1):
            off, w, h, s0, t0, _, _ = A._bilerp_setup(meta, img, li, st_k)
            if quad:
                rows.append((off + torch.remainder(t0, h) * w
                             + torch.remainder(s0, w)).long())
                continue
            for ds, dt in ((0, 0), (1, 0), (0, 1), (1, 1)):
                idx, read = _texel_index(off, w, h, wrap, s0 + ds, t0 + dt)
                rows.append(idx[read])
    return torch.unique(torch.cat(rows))


def k5_work(meta, levels, regs, reg, si, quad):
    """-> dict(lanes, textured, rows (distinct rows or texels read),
    bytes, ops) of one K5 call on these inputs."""
    n = reg.shape[0]
    textured = int((reg >= 0).sum())
    rows = k5_rows(meta, levels, regs, reg, si, quad).numel()
    moved = n * LANE_BYTES + textured * TEXTURED_LANE_BYTES \
        + rows * (QUAD_ROW_BYTES if quad else TEXEL_BYTES)
    return dict(lanes=n, textured=textured, rows=rows, bytes=moved,
                ops=textured * K5_LANE_OPS)


def k5_bound(work):
    """-> (bound ms, "bytes" or "operations") of a K5 call doing ``work``."""
    t_bytes = work["bytes"] / PEAK_BYTES_PER_S
    t_ops = work["ops"] / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def k10_work(meta, levels, regs, reg, si, n_texels):
    """-> dict(lanes, textured, bytes, ops) of one K10 call on these
    inputs: every lane's registration read, each textured lane's uv,
    differentials and gradient, and the (T, 3) texel gradient written once;
    K10_LANE_OPS a textured lane."""
    n = reg.shape[0]
    textured = int((reg >= 0).sum())
    moved = n * 4 + textured * (TEXTURED_LANE_BYTES + K10_LANE_BYTES) \
        + n_texels * TEXEL_BYTES
    return dict(lanes=n, textured=textured, bytes=moved,
                ops=textured * K10_LANE_OPS)


def _k10_taps(meta, levels, regs, reg, si, quad):
    """The taps of K10's textured lanes, in lane order -> dict of lanes
    (L,) int64 and, per lane: the two levels' (off, w, h) (L, 2) each,
    wrap (L,), dl (L,), and per level and tap (L, 2, 8): s0, t0 (int32),
    ds, dt and the tap weight wk * lw (float32)."""
    lanes = torch.nonzero(reg >= 0).flatten()
    sub = SimpleNamespace(**{f: getattr(si, f)[lanes] for f in A.SI_FIELDS})
    _, img, wrap, st, major, minor_len = A._ewa_axes(regs, reg[lanes], sub)
    if quad:
        wrap = torch.full_like(wrap, WRAP_REPEAT)
    level, big_l = A.ewa_level(levels, img, minor_len)
    l0 = torch.floor(level).int()
    l1 = torch.minimum(l0 + 1, big_l - 1)
    dl = level - l0
    out = {k: [[None] * 8 for _ in range(2)]
           for k in ("s0", "t0", "ds", "dt", "f")}
    lv = []
    for li, (lev, lw) in enumerate(((l0, 1.0 - dl), (l1, dl))):
        for k, (a, _) in enumerate(A.TAPS):
            off, w, h, s0, t0, ds, dt = A._bilerp_setup(meta, img, lev,
                                                        st + a * major)
            for name, v in (("s0", s0), ("t0", t0), ("ds", ds[:, 0]),
                            ("dt", dt[:, 0]),
                            ("f", A.TAP_WEIGHTS32[k] * lw)):
                out[name][li][k] = v
        lv.append((off, w, h))
    res = {k: torch.stack([torch.stack(v, -1) for v in out[k]], 1)
           for k in out}
    res.update(lanes=lanes, wrap=wrap, dl=dl,
               **{k: torch.stack([x[i] for x in lv], 1)
                  for i, k in enumerate(("off", "w", "h"))})
    return res


def _corner_keys(off, w, h, wrap, s0, t0):
    """-> (4, N) texel of each corner of the quads at (s0, t0), -1 where a
    WRAP_BLACK corner falls outside its level."""
    keys = []
    for cs, ct in ((0, 0), (1, 0), (0, 1), (1, 1)):
        key, read = _texel_index(off, w, h, wrap, s0 + cs, t0 + ct)
        keys.append(torch.where(read, key, -1))
    return torch.stack(keys)


def packed_warps(lanes, tile=K10_TILE, most=8, least=1):
    """The packing of the texel-gradient kernels (csrc/texel_grad.cuh
    pack_tile, rounds, group_of) of the lanes that add (sorted lane
    indices ``lanes``): tiles of ``tile`` lanes on K10_THREADS threads, G
    threads a lookup by the tile's count (the most of ``least``, 2
    ``least``, ..., ``most`` that run it in one round) -> (G (L,), warp
    (L,): an id of the warp that runs each lookup's threads, in its
    round)."""
    first = torch.searchsorted(lanes // tile, lanes // tile)
    tile_of = lanes // tile
    rank = torch.arange(lanes.numel(), device=lanes.device) - first
    count = torch.bincount(tile_of)[tile_of]
    grp = torch.full_like(count, least)
    while True:
        up = (grp < most) & (2 * grp * count <= K10_THREADS)
        if not bool(up.any()):
            break
        grp = torch.where(up, 2 * grp, grp)
    per_round = K10_THREADS // grp
    warp = (tile_of * (tile // per_round + 1) + rank // per_round) \
        * (K10_THREADS // 32) + (rank % per_round) // (32 // grp)
    return grp, warp


def _k10_new(tp, g, wsum_scale, n_texels, tile=K10_TILE, least=1):
    """The global atomics of this K10 (csrc/atlas_bwd.cu) on the taps
    ``tp`` (_k10_taps) and the lanes' scaled gradients ``wsum_scale`` *
    g: the textured lanes packed per tile (``tile`` lanes), G threads a
    lookup (packed_warps, at least ``least``), two open quads a thread,
    quads added at the kernel's call sites, each corner summed over the
    warp's lanes with its texel -> count of adds of a nonzero sum, one a
    channel. K20's 8-tap lookups (texture_work.k20_atomics) take the same
    code."""
    lanes = tp["lanes"]
    dev = lanes.device
    grp, warp_of = packed_warps(lanes, tile, 8, least)
    events = []
    for G in (1, 2, 4, 8):
        sel = torch.nonzero(grp == G).flatten()
        if not sel.numel():
            continue
        T = 8 // G
        # the G threads of each lookup, each taps k0 .. k0 + T - 1
        look = sel.repeat_interleave(G)
        warp = warp_of[sel].repeat_interleave(G)
        k0 = torch.arange(G, device=dev).repeat(sel.numel()) * T
        events += _k10_thread_events(tp, look, warp, k0, T, g, wsum_scale,
                                     n_texels)
    if not events:
        return 0
    ids, val = (torch.cat(x) for x in zip(*events))
    ids, inv = torch.unique(ids, return_inverse=True)
    sums = torch.zeros((ids.numel(), 3), dtype=val.dtype, device=dev)
    sums.index_add_(0, inv, val)
    return int((sums != 0).sum())


def _k10_thread_events(tp, look, warp, k0, T, g, wsum_scale, n_texels):
    """The corner adds of one set of K10's threads (lookup ``look``, warp
    ``warp``, taps k0 .. k0 + T - 1) -> [(id, (3,) value)] for each call
    site and corner, id = (warp x 80 + call site x 4 + corner) x n_texels
    + texel, for the adds that reach a texel."""
    dev = look.device
    gv = (g[tp["lanes"][look]] * wsum_scale[look][:, None]).float()
    wrap = tp["wrap"][look]
    flat = (tp["dl"][look] == 0) & torch.isfinite(gv).all(-1)
    # a warp skips level 1 where all its lanes are flat
    wid, winv = torch.unique(warp, return_inverse=True)
    all_flat = torch.ones(wid.numel(), dtype=torch.int32, device=dev)
    all_flat.scatter_reduce_(0, winv, flat.int(), "amin")
    n_levels = torch.where(all_flat[winv] == 1, 1, 2)
    lv = [tuple(tp[k][look, li] for k in ("off", "w", "h")) for li in (0, 1)]
    z = torch.zeros_like(look)
    state = dict(has_a=z.bool(), has_b=z.bool(), as_=z.int(), at=z.int(),
                 bs=z.int(), bt=z.int(), q=0,
                 wa=torch.zeros((look.numel(), 4), device=dev),
                 wb=torch.zeros((look.numel(), 4), device=dev))
    qlv = [x.clone() for x in lv[0]]
    events = []

    def emit(site, mask, s0, t0, w):
        keys = _corner_keys(*qlv, wrap, s0, t0)                  # (4, N)
        w = w.clone()
        for c in range(1, 4):                  # corners on one texel
            for d in range(c):
                same = (keys[c] >= 0) & (keys[c] == keys[d])
                w[:, d] += torch.where(same, w[:, c], 0.0)
                w[:, c] = torch.where(same, 0.0, w[:, c])
                keys[c] = torch.where(same, -1, keys[c])
        for c in range(4):
            ok = mask & (keys[c] >= 0)
            events.append(((warp[ok] * 80 + 4 * site + c) * n_texels
                           + keys[c][ok], w[ok, c, None] * gv[ok]))

    st = state
    for li in (0, 1):
        live = n_levels > li
        if li:
            moved = live & (lv[1][0] != qlv[0])
            emit(0, moved, st["as_"], st["at"], st["wa"])
            emit(1, moved & st["has_b"], st["bs"], st["bt"], st["wb"])
            st["has_a"] = st["has_a"] & ~moved
            st["has_b"] = st["has_b"] & ~moved
            qlv = [torch.where(live, a, b) for a, b in zip(lv[1], qlv)]
        for m in range(T):
            k = k0 + m
            idx = look, torch.full_like(look, li), k
            s0, t0 = tp["s0"][idx].int(), tp["t0"][idx].int()
            ds, dt, f = tp["ds"][idx], tp["dt"][idx], tp["f"][idx]
            in_a = st["has_a"] & (s0 == st["as_"]) & (st["at"] == t0)
            in_b = st["has_b"] & (s0 == st["bs"]) & (st["bt"] == t0)
            fresh = live & ~in_a & ~in_b
            spill = fresh & st["has_b"]
            emit(2 + li * 8 + m, spill, st["as_"], st["at"], st["wa"])
            st["as_"] = torch.where(spill, st["bs"], st["as_"])
            st["at"] = torch.where(spill, st["bt"], st["at"])
            st["wa"] = torch.where(spill[:, None], st["wb"], st["wa"])
            st["has_b"] = st["has_b"] & ~spill
            to_b = in_b | (fresh & st["has_a"])
            new_b, new_a = fresh & to_b, fresh & ~to_b
            st["bs"] = torch.where(new_b, s0, st["bs"])
            st["bt"] = torch.where(new_b, t0, st["bt"])
            st["wb"] = torch.where(new_b[:, None], 0.0, st["wb"])
            st["has_b"] = st["has_b"] | new_b
            st["as_"] = torch.where(new_a, s0, st["as_"])
            st["at"] = torch.where(new_a, t0, st["at"])
            st["wa"] = torch.where(new_a[:, None], 0.0, st["wa"])
            st["has_a"] = st["has_a"] | new_a
            wc = torch.stack([f * ((1 - ds) * (1 - dt)), f * (ds * (1 - dt)),
                              f * ((1 - ds) * dt), f * (ds * dt)], -1)
            wc = torch.where(live[:, None], wc, 0.0)
            st["wa"] = st["wa"] + torch.where(to_b[:, None], 0.0, wc)
            st["wb"] = st["wb"] + torch.where(to_b[:, None], wc, 0.0)
    emit(18, st["has_a"], st["as_"], st["at"], st["wa"])
    emit(19, st["has_b"], st["bs"], st["bt"], st["wb"])
    return events


def k10_atomics(meta, levels, regs, reg, si, quad, g, n_texels):
    """The global atomics one K10 call issues, counted from its inputs ->
    dict of:

    - adds: the adds of the textured lanes that reach a texel, 64 a lane
      (fewer where WRAP_BLACK corners fall outside);
    - parent: the earlier kernel's (one thread a lane, the lanes of a
      warp that add into one texel at one of the 64 adds summed first):
      distinct (warp, add number, texel) x 3;
    - new: this kernel's (csrc/atlas_bwd.cu), replayed: the lanes packed
      per tile, G threads a lookup, two open quads a thread, a quad's
      corners summed over the warp's lanes with the same texel at the same
      call site, one add a channel of a nonzero sum;
    - max_adds_texel: the most adds that land on one texel."""
    tp = _k10_taps(meta, levels, regs, reg, si, quad)
    if not tp["lanes"].numel():
        return dict(adds=0, parent=0, new=0, max_adds_texel=0)
    keys = _corner_keys(tp["off"][:, :, None], tp["w"][:, :, None],
                        tp["h"][:, :, None], tp["wrap"][:, None, None],
                        tp["s0"], tp["t0"])                  # (4, L, 2, 8)
    lane = tp["lanes"][None, :, None, None].expand_as(keys)
    # the parent's add number (k * 2 + level) * 4 + corner
    it = (torch.arange(8, device=keys.device)[None, None, None, :] * 2
          + torch.arange(2, device=keys.device)[None, None, :, None]) * 4 \
        + torch.arange(4, device=keys.device)[:, None, None, None]
    it = it.expand_as(keys)
    ok = keys >= 0
    parent = torch.unique((lane[ok] // 32 * 64 + it[ok]) * n_texels
                          + keys[ok]).numel()
    scale = regs["reg_scale"][reg[tp["lanes"]].long()] / A.WSUM32
    return dict(adds=int(ok.sum()), parent=3 * parent,
                new=_k10_new(tp, g, scale, n_texels),
                max_adds_texel=int(torch.bincount(keys[ok]).max()))
