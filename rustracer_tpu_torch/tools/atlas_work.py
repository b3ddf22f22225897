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
