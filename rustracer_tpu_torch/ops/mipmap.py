"""MIP pyramids and the per-texture filtered lookups (port of
rustracer_tpu/ops/mipmap.py) with their hand kernel K17 (csrc/mipmap.cu).

The wrap modes, the host-side pyramid build and the one-level bilinear
lookup (``bilerp_level``, which the infinite lights' maps use), and the
three lookups an image texture makes outside the shared atlas
(scene/atlas.py): ``lookup_trilinear`` (an isotropic footprint between two
levels), ``lookup_ewa`` (8 trilinear taps along the major axis, Gaussian
weighted, the level from the minor axis) and ``lookup_ewa_exact`` (the
reference's EWA texel loop over the ellipse's bounding box, a fixed trip
of 128 texels at the rounded level, falling back to a bilinear lookup
where no texel lands).

A lookup reads one image's levels from a flat array of texel rows
(``Texels``): the scene's atlas texels, (T, 3) or the (T, 12) quad rows
whose first three floats are the texel, with the image's [offset, w, h]
level rows, so a scene keeps one copy of its images on the device
(``pyramid_texels`` builds such rows for a pyramid of its own, and
``bilerp_level`` reads one level through the same bilinear path). The plain
versions (``trilinear_plain``, ``ewa_plain``, ``ewa_exact_plain``) take
each lane's own level(s) from the level rows; the reference's masked loop
over every level gives the same sums. CPU tensors take them, CUDA tensors
launch K17. The result has the image's C channels (1 or 3).

The texel gradient (the reference's by JAX's autodiff) is hand kernel K20
(csrc/mipmap_bwd.cu, ``mipmap_lookup_bwd``; plain version
``mipmap_lookup_bwd_plain``, autograd of the plain lookups): with grad mode
on and texel rows that require grad, a lookup runs as the autograd
Function ``_MipmapLookup``, K17 forward and K20 backward. Its texels are
then the (T, 3) rows (a scene whose atlas holds quad rows hands its (T, 3)
rows in grad mode: a quad row's corners are the very texels the stride-3
addressing reaches), and the gradient lands in them. The lookup's
coordinates (st, the width, the differentials) carry no gradient: one that
requires grad raises NotImplementedError (ROADMAP item B12).

While a render counts (utils/stats.py), each lookup adds its lane count to
"Textures/Trilinear lookups" or "Textures/EWA lookups" (the reference's
mipmap.rs:17-19 counters): the lanes it was called with, a host int.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import cuda
from ..utils import stats as S

WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP = 0, 1, 2
# K17's modes
TRILINEAR, EWA, EWA_EXACT = 0, 1, 2
N_TAPS = 8
N_TAPS_EXACT = 128
_E2 = float(np.float32(np.exp(-2.0)))


def ewa_taps(n_taps=N_TAPS):
    """-> ([(offset a along the major axis, float64 weight)], float64
    sum): the Gaussian ellipse weights exp(-2 r^2) - exp(-2) at the taps'
    positions (mipmap.rs ewa()'s weight table)."""
    taps, wsum = [], 0.0
    for i in range(n_taps):
        a = (i + 0.5) / n_taps - 0.5
        r2 = (2.0 * a) ** 2
        wgt = float(np.exp(-2.0 * r2) - np.exp(-2.0))
        taps.append((a, wgt))
        wsum += wgt
    return taps, wsum


# the weights and their sum rounded to float32, where they meet the
# float32 lookups (JAX's weak typing)
TAPS, WSUM = ewa_taps()
TAP_WEIGHTS32 = [float(np.float32(w)) for _, w in TAPS]
WSUM32 = float(np.float32(WSUM))


class Texels(NamedTuple):
    """One image's pyramid in a flat array of texel rows: what K17 reads."""
    texels: torch.Tensor   # (T, 3) or (T, 12) float32, the texel first
    meta: torch.Tensor     # (L, 3) int32 [offset, w, h] of its levels
    channels: int          # C of the image (1 or 3)


def pyramid_texels(pyramid) -> Texels:
    """A list of (H, W[, C]) levels (tensors) -> Texels of their own
    (T, 3) array in the atlas's layout (scene/atlas.py atlas_texels: a
    1-channel image replicated to 3). A scene's lookups read its atlas's
    rows instead (scene/textures.py image_texels)."""
    from ..scene.atlas import atlas_texels
    meta, off = [], 0
    for lv in pyramid:
        h, w = lv.shape[:2]
        meta.append((off, w, h))
        off += h * w
    lv0 = pyramid[0]
    return Texels(atlas_texels([pyramid]).to(lv0.device),
                  torch.tensor(meta, dtype=torch.int32, device=lv0.device),
                  1 if lv0.dim() == 2 else int(lv0.shape[-1]))


def build_pyramid(img: np.ndarray):
    """Host-side pyramid build: bilinear resample to power-of-two sides,
    then 2x box filtering down to 1x1. -> list of float32 (H, W, C)
    levels, bit-equal with the reference's."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    h2 = 1 << int(np.ceil(np.log2(max(1, h))))
    w2 = 1 << int(np.ceil(np.log2(max(1, w))))
    if (h2, w2) != (h, w):
        yi = np.linspace(0, h - 1, h2)
        xi = np.linspace(0, w - 1, w2)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        img = ((1 - fy) * (1 - fx) * img[y0][:, x0]
               + (1 - fy) * fx * img[y0][:, x1]
               + fy * (1 - fx) * img[y1][:, x0]
               + fy * fx * img[y1][:, x1]).astype(np.float32)
        h, w = h2, w2
    levels = [img]
    while h > 1 or w > 1:
        nh, nw = max(1, h // 2), max(1, w // 2)
        cur = levels[-1][: nh * 2, : nw * 2]
        if h == 1:
            nxt = 0.5 * (cur[:, 0::2] + cur[:, 1::2])
        elif w == 1:
            nxt = 0.5 * (cur[0::2] + cur[1::2])
        else:
            nxt = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(nxt.astype(np.float32))
        h, w = nh, nw
    return levels


# --- the per-texture lookups: plain versions on the flat texel rows ---

def _rows(tx: Texels, li):
    m = tx.meta[li.long()]
    return m[:, 0], m[:, 1], m[:, 2]


def _texel_rows(tx: Texels, off, w, h, wrap, s_i, t_i):
    """Texels (B, 3) at integer (s_i, t_i) of the lanes' levels (offset,
    w, h) under the static ``wrap`` (_texel)."""
    mask = None
    if wrap == WRAP_REPEAT:
        s_f, t_f = torch.remainder(s_i, w), torch.remainder(t_i, h)
    else:
        if wrap == WRAP_BLACK:
            mask = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
        s_f = torch.minimum(torch.clamp(s_i, min=0), w - 1)
        t_f = torch.minimum(torch.clamp(t_i, min=0), h - 1)
    v = tx.texels[(off + t_f * w + s_f).long(), :3]
    return v if mask is None else torch.where(mask[:, None], v, 0.0)


def bilerp_corner(tx: Texels, li, st):
    """-> (offset, w, h, s0, t0, ds, dt) of the bilinear lookup at each
    lane's level ``li``: the level's rows, its lower-left texel and the
    fractions."""
    off, w, h = _rows(tx, li)
    s = st[:, 0] * w.float() - 0.5
    t = st[:, 1] * h.float() - 0.5
    s0 = torch.floor(s).int()
    t0 = torch.floor(t).int()
    return off, w, h, s0, t0, (s - s0)[:, None], (t - t0)[:, None]


def _bilerp_rows(tx: Texels, li, st, wrap):
    """Bilinear lookup at continuous st (B, 2) in texel units of [0, 1)^2
    (centres at half-integers) of each lane's level ``li`` (B,) -> (B, C)
    of the rows' first C <= 3 floats."""
    off, w, h, s0, t0, ds, dt = bilerp_corner(tx, li, st)
    v00 = _texel_rows(tx, off, w, h, wrap, s0, t0)
    v10 = _texel_rows(tx, off, w, h, wrap, s0 + 1, t0)
    v01 = _texel_rows(tx, off, w, h, wrap, s0, t0 + 1)
    v11 = _texel_rows(tx, off, w, h, wrap, s0 + 1, t0 + 1)
    return (1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + \
        (1 - ds) * dt * v01 + ds * dt * v11


def level_texels(level) -> Texels:
    """One (H, W, C) level as Texels of its own rows (a view, no copy)."""
    h, w, c = level.shape
    return Texels(level.reshape(h * w, c),
                  torch.tensor([[0, w, h]], dtype=torch.int32,
                               device=level.device), c)


def bilerp_level(level, st, wrap):
    """Bilinear lookup of one level (H, W, C) at continuous st (B, 2) under
    ``wrap`` -> (B, C)."""
    li = torch.zeros(st.shape[0], dtype=torch.int32, device=st.device)
    return _bilerp_rows(level_texels(level), li, st, wrap)


def tri_levels(tx: Texels, width):
    """-> (l0, l1, dl): the two levels of a trilinear lookup of filter
    width ``width`` and the blend between them."""
    n = tx.meta.shape[0]
    level = torch.clamp((n - 1) + torch.log2(torch.clamp(width, min=1e-8)),
                        0.0, n - 1)
    l0 = torch.floor(level).int()
    return l0, torch.clamp(l0 + 1, max=n - 1), (level - l0)[:, None]


def trilinear_plain(tx: Texels, st, width, wrap=WRAP_REPEAT):
    """Plain version of K17's trilinear mode: the level (L - 1) +
    log2(width) clipped to [0, L - 1], bilinear at its floor and the next
    level, blended. -> (B, 3)."""
    l0, l1, dl = tri_levels(tx, width)
    return (1.0 - dl) * _bilerp_rows(tx, l0, st, wrap) \
        + dl * _bilerp_rows(tx, l1, st, wrap)


def _lengths(dst0, dst1):
    len0 = torch.sqrt(torch.clamp((dst0 * dst0).sum(-1), min=1e-24))
    len1 = torch.sqrt(torch.clamp((dst1 * dst1).sum(-1), min=1e-24))
    return len0, len1


def ewa_axes(dst0, dst1, max_anisotropy):
    """-> (major axis (B, 2), minor length (B,)) of the 8-tap lookup: the
    longer differential, and the shorter's length raised so that
    major/minor <= max_anisotropy."""
    len0, len1 = _lengths(dst0, dst1)
    major_is_0 = len0 >= len1
    major_len = torch.where(major_is_0, len0, len1)
    minor_len = torch.where(major_is_0, len1, len0)
    major = torch.where(major_is_0[:, None], dst0, dst1)
    return major, torch.maximum(
        minor_len, major_len / float(np.float32(max_anisotropy)))


def ewa_plain(tx: Texels, st, dst0, dst1, max_anisotropy=8.0,
              wrap=WRAP_REPEAT):
    """Plain version of K17's EWA mode (lookup_ewa): the minor axis,
    scaled up so major/minor <= max_anisotropy, picks the level; 8
    trilinear taps along the major axis, Gaussian weighted. -> (B, 3)."""
    major, minor_len = ewa_axes(dst0, dst1, max_anisotropy)
    out = torch.zeros((st.shape[0], 3), dtype=torch.float32,
                      device=st.device)
    for (a, _), w in zip(TAPS, TAP_WEIGHTS32):
        out = out + w * trilinear_plain(tx, st + a * major, minor_len, wrap)
    return out / WSUM32


class Ellipse(NamedTuple):
    """The exact lookup's footprint at its level: the level's rows, the
    texel-space centre, the implicit ellipse A x^2 + B x y + C y^2 < 1 and
    its bounding box's first texel and width, and the box's texel count."""
    li: torch.Tensor
    off: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    s0: torch.Tensor
    t0: torch.Tensor
    wu: torch.Tensor
    n_box: torch.Tensor


def exact_lod(tx: Texels, dst0, dst1, max_anisotropy):
    """-> (major, minor (B, 2), lod (B,)): the exact lookup's axes, the
    minor one scaled up to the anisotropy clamp, and the continuous level
    of its length, which the lookup rounds."""
    len0, len1 = _lengths(dst0, dst1)
    swap = len1 > len0
    major = torch.where(swap[:, None], dst1, dst0)
    minor = torch.where(swap[:, None], dst0, dst1)
    major_len = torch.maximum(len0, len1)
    minor_len = torch.minimum(len0, len1)
    ma = float(np.float32(max_anisotropy))
    scale = torch.where(minor_len * ma < major_len,
                        major_len / (minor_len * ma + 1e-24), 1.0)
    minor = minor * scale[:, None]
    minor_len = minor_len * scale
    n = tx.meta.shape[0]
    lod = torch.clamp((n - 1) + torch.log2(torch.clamp(minor_len, min=1e-8)),
                      0.0, n - 1)
    return major, minor, lod


def ellipse(tx: Texels, st, dst0, dst1, max_anisotropy) -> Ellipse:
    """The exact lookup's set-up (mipmap.rs:330-356): the minor axis
    scaled up to the anisotropy clamp, the level rounded from its length,
    the ellipse's coefficients and bounding box at that level."""
    major, minor, lod = exact_lod(tx, dst0, dst1, max_anisotropy)
    li = torch.round(lod).int()
    off, w, h = _rows(tx, li)
    wf, hf = w.float(), h.float()
    d0x, d0y = major[:, 0] * wf, major[:, 1] * hf
    d1x, d1y = minor[:, 0] * wf, minor[:, 1] * hf
    px = st[:, 0] * wf - 0.5
    py = st[:, 1] * hf - 0.5
    a = d0y * d0y + d1y * d1y + 1.0
    b = -2.0 * (d0x * d0y + d1x * d1y)
    c = d0x * d0x + d1x * d1x + 1.0
    inv_f = 1.0 / torch.clamp(a * c - b * b * 0.25, min=1e-12)
    a, b, c = a * inv_f, b * inv_f, c * inv_f
    det = torch.clamp(-b * b + 4.0 * a * c, min=1e-12)
    u_r = torch.sqrt(torch.clamp(c * det, min=0.0)) * 2.0 / det
    v_r = torch.sqrt(torch.clamp(a * det, min=0.0)) * 2.0 / det
    s0 = torch.ceil(px - u_r).int()
    s1 = torch.floor(px + u_r).int()
    t0 = torch.ceil(py - v_r).int()
    t1 = torch.floor(py + v_r).int()
    wu = torch.clamp(s1 - s0 + 1, min=1)
    wv = torch.clamp(t1 - t0 + 1, min=1)
    return Ellipse(li, off, w, h, px, py, a, b, c, s0, t0, wu,
                   wu.long() * wv.long())


def ellipse_tap(e: Ellipse, k: int):
    """-> (s, t, in): tap ``k``'s texel (s0 + k % wu, t0 + k // wu) and
    whether it is a tap of the box that lies inside the ellipse, with its
    r^2."""
    kk = torch.full_like(e.wu, k)
    ss = e.s0 + torch.remainder(kk, e.wu)
    tt = e.t0 + torch.div(kk, e.wu, rounding_mode="floor")
    du = ss.float() - e.px
    dv = tt.float() - e.py
    r2 = e.a * du * du + e.b * du * dv + e.c * dv * dv
    return ss, tt, (k < e.n_box) & (r2 < 1.0), r2


def ewa_exact_plain(tx: Texels, st, dst0, dst1, max_anisotropy=16.0,
                    wrap=WRAP_REPEAT, n_taps=N_TAPS_EXACT):
    """Plain version of K17's exact mode (lookup_ewa_exact): the
    reference's EWA texel loop at the level rounded from the minor axis,
    ``n_taps`` texels of the ellipse's bounding box enumerated as
    (s0 + k % wu, t0 + k // wu) and truncated past ``n_taps``; a bilinear
    lookup at that level where no texel lands inside. -> (B, 3)."""
    e = ellipse(tx, st, dst0, dst1, max_anisotropy)
    out = torch.zeros((st.shape[0], 3), dtype=torch.float32,
                      device=st.device)
    wsum = torch.zeros_like(e.px)
    for k in range(n_taps):
        ss, tt, ok, r2 = ellipse_tap(e, k)
        wgt = torch.where(ok, torch.exp(-2.0 * r2) - _E2, 0.0)
        out = out + wgt[:, None] * _texel_rows(tx, e.off, e.w, e.h, wrap, ss,
                                               tt)
        wsum = wsum + wgt
    fb = _bilerp_rows(tx, e.li, st, wrap)
    return torch.where((wsum > 1e-9)[:, None],
                       out / torch.clamp(wsum, min=1e-9)[:, None], fb)


def _k17(tx: Texels, mode, wrap, st, dst0=None, dst1=None, width=None,
         max_anisotropy=8.0, lib=None):
    """K17 in ``mode`` -> (B, 3); ``lib`` another build of the kernel
    (cuda.launch)."""
    n = st.shape[0]
    dev = st.device
    stride = tx.texels.shape[1]
    if stride not in (3, 12):
        raise ValueError(f"texels: rows of 3 or 12 floats, not {stride}")
    cuda.check(tx.texels, "texels", torch.float32,
               (tx.texels.shape[0], stride), dev, align=16)
    cuda.check(tx.meta, "meta", torch.int32, (tx.meta.shape[0], 3), dev)
    cuda.check(st, "st", torch.float32, (n, 2), dev)
    if mode == TRILINEAR:
        cuda.check(width, "width", torch.float32, (n,), dev)
    else:
        cuda.check(dst0, "dst0", torch.float32, (n, 2), dev)
        cuda.check(dst1, "dst1", torch.float32, (n, 2), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        cuda.launch("mipmap_lookup", tx.texels, stride, tx.meta,
                    tx.meta.shape[0], int(wrap), mode, st, dst0, dst1, width,
                    float(np.float32(max_anisotropy)), n, *TAP_WEIGHTS32,
                    WSUM32, _E2, out, lib=lib)
    return out


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


_PLAIN = {TRILINEAR: lambda tx, st, d0, d1, w, ma, wrap:
          trilinear_plain(tx, st, w, wrap),
          EWA: lambda tx, st, d0, d1, w, ma, wrap:
          ewa_plain(tx, st, d0, d1, ma, wrap),
          EWA_EXACT: lambda tx, st, d0, d1, w, ma, wrap:
          ewa_exact_plain(tx, st, d0, d1, ma, wrap)}


def _lookup(tx: Texels, mode, wrap, st, dst0, dst1, width, max_anisotropy):
    """K17 (CUDA) or its plain version (CPU) -> (B, 3)."""
    if not cuda.use_kernel(st):
        return _PLAIN[mode](tx, st, dst0, dst1, width, max_anisotropy, wrap)
    st, dst0, dst1, width = _contig(st, dst0, dst1, width)
    return _k17(tx, mode, wrap, st, dst0, dst1, width, max_anisotropy)


def mipmap_lookup_bwd_plain(g, tx: Texels, mode, wrap, st, dst0=None,
                            dst1=None, width=None, max_anisotropy=8.0):
    """Plain version of K20: autograd of ``trilinear_plain``,
    ``ewa_plain`` or ``ewa_exact_plain`` (``mode``) with respect to the
    (T, 3) texel rows ``tx.texels`` -> their (T, 3) gradient for the
    lookups' gradient ``g`` (B, 3)."""
    with torch.enable_grad():
        t = tx.texels.detach().requires_grad_()
        out = _PLAIN[mode](tx._replace(texels=t), st, dst0, dst1, width,
                           max_anisotropy, wrap)
        return torch.autograd.grad(out, t, g)[0]


def mipmap_lookup_bwd(g, tx: Texels, mode, wrap, st, dst0=None, dst1=None,
                      width=None, max_anisotropy=8.0):
    """The (T, 3) gradient of the texel rows ``tx.texels`` of one K17 call
    (``mode``, ``wrap``, its st and width or differentials) for the
    lookups' gradient ``g`` (B, 3). CPU tensors take the plain version,
    CUDA tensors launch K20."""
    if not cuda.use_kernel(st):
        return mipmap_lookup_bwd_plain(g, tx, mode, wrap, st, dst0, dst1,
                                       width, max_anisotropy)
    g, st, dst0, dst1, width = _contig(g, st, dst0, dst1, width)
    return _k20(g, tx, mode, wrap, st, dst0, dst1, width, max_anisotropy)


def _k20(g, tx: Texels, mode, wrap, st, dst0=None, dst1=None, width=None,
         max_anisotropy=8.0, lib=None, group=0):
    """K20 in ``mode`` -> the (T, 3) texel gradient; ``group`` its threads
    a lookup (0: each block's choice; csrc/mipmap_bwd.cu has_route); ``lib``
    another build of the kernel (cuda.launch)."""
    n, dev = st.shape[0], st.device
    n_texels = tx.texels.shape[0]
    cuda.check(g, "g", torch.float32, (n, 3), dev)
    cuda.check(tx.texels, "texels", torch.float32, (n_texels, 3), dev)
    cuda.check(tx.meta, "meta", torch.int32, (tx.meta.shape[0], 3), dev)
    cuda.check(st, "st", torch.float32, (n, 2), dev)
    if mode == TRILINEAR:
        cuda.check(width, "width", torch.float32, (n,), dev)
    else:
        cuda.check(dst0, "dst0", torch.float32, (n, 2), dev)
        cuda.check(dst1, "dst1", torch.float32, (n, 2), dev)
    out = torch.zeros((n_texels, 3), dtype=torch.float32, device=dev)
    if n:
        cuda.launch("mipmap_lookup_bwd", g, tx.meta, tx.meta.shape[0],
                    int(wrap), mode, st, dst0, dst1, width,
                    float(np.float32(max_anisotropy)), n, *TAP_WEIGHTS32,
                    WSUM32, _E2, out, n_texels, group, lib=lib)
    return out


class _MipmapLookup(torch.autograd.Function):
    """K17 forward, K20 backward (gradient to the (T, 3) texel rows only;
    the coordinates are refused beforehand, ``_route``)."""

    @staticmethod
    def forward(ctx, texels, tx, mode, wrap, st, dst0, dst1, width,
                max_anisotropy):
        tx = tx._replace(texels=texels)
        with cuda.differentiable():
            out = _lookup(tx, mode, wrap, st, dst0, dst1, width,
                          max_anisotropy)
        ctx.save_for_backward(texels, st, dst0, dst1, width)
        ctx.args = (tx.meta, tx.channels, mode, wrap, max_anisotropy)
        return out

    @staticmethod
    def backward(ctx, g):
        texels, st, dst0, dst1, width = ctx.saved_tensors
        meta, channels, mode, wrap, ma = ctx.args
        with cuda.differentiable():
            g_tex = mipmap_lookup_bwd(g.contiguous(),
                                      Texels(texels, meta, channels),
                                      mode, wrap, st, dst0, dst1, width, ma)
        return (g_tex,) + (None,) * 8


def _route(tx: Texels, mode, wrap, st, dst0=None, dst1=None, width=None,
           max_anisotropy=8.0):
    """One lookup of ``tx`` in ``mode`` -> (B, C): differentiable in the
    texel rows (``_MipmapLookup``) where grad mode is on and they require
    grad, else K17 or its plain version; coordinates that require grad
    raise (ROADMAP item B12)."""
    cuda.refuse_grad("a gradient through a texture lookup's coordinates "
                     "(st, its width or differentials)", (st, dst0, dst1,
                                                          width))
    S.device_count("Textures/Trilinear lookups" if mode == TRILINEAR
                   else "Textures/EWA lookups", st.shape[0])
    if torch.is_grad_enabled() and tx.texels.requires_grad:
        out = _MipmapLookup.apply(tx.texels, tx, mode, wrap, st, dst0, dst1,
                                  width, max_anisotropy)
    else:
        out = _lookup(tx, mode, wrap, st, dst0, dst1, width, max_anisotropy)
    return out[:, :tx.channels]


def lookup_trilinear(tx: Texels, st, width, wrap=WRAP_REPEAT):
    """Trilinear (isotropic) lookup of one image's pyramid ``tx`` at st
    (B, 2) with filter width (B,) -> (B, C). CPU tensors take the plain
    version, CUDA tensors launch K17 (K20 in the backward)."""
    return _route(tx, TRILINEAR, wrap, st, width=width)


def lookup_ewa(tx: Texels, st, dst0, dst1, max_anisotropy=8.0,
               wrap=WRAP_REPEAT):
    """The 8-tap anisotropic lookup of ``tx`` at st (B, 2) with texture
    differentials dst0, dst1 (B, 2) -> (B, C). CPU tensors take the plain
    version, CUDA tensors launch K17 (K20 in the backward)."""
    return _route(tx, EWA, wrap, st, dst0, dst1,
                  max_anisotropy=max_anisotropy)


def lookup_ewa_exact(tx: Texels, st, dst0, dst1, max_anisotropy=16.0,
                     wrap=WRAP_REPEAT):
    """The EWA texel loop (128 texels) of ``tx`` at st (B, 2) with texture
    differentials dst0, dst1 (B, 2) -> (B, C). CPU tensors take the plain
    version, CUDA tensors launch K17 (K20 in the backward)."""
    return _route(tx, EWA_EXACT, wrap, st, dst0, dst1,
                  max_anisotropy=max_anisotropy)
