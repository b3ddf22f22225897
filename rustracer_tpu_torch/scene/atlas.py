"""Shared mip atlas (port of rustracer_tpu/scene/atlas.py) and its hand
kernel K5 (csrc/atlas.cu).

Every imagemap pyramid is packed into one flat texel array with per-(image,
level) offset metadata, and a "registration" (one ImageTexture: image id,
UV scale/offset, wrap mode, scalar scale) becomes a per-lane gather index,
so the material set makes one EWA lookup per parameter slot for the whole
wavefront however many imagemap materials the scene has. Metadata and
registrations are host numpy; the texel arrays are built from
``textures["images"]``.

``atlas_lookup_ewa_plain`` is the reference's lookup in plain PyTorch; the
kernel runs the same arithmetic with one thread per lane.
``atlas_lookup_ewa_grad`` is the lookup differentiable in the (T, 3)
texels, an autograd Function whose backward is hand kernel K10
(csrc/atlas_bwd.cu); for the quad layout it builds the quad rows from the
(T, 3) texels itself (``atlas_quad_index``), so the gradient lands in the
(T, 3) array and no (T, 12) gradient is ever folded. The tap weights
are float64 Python numbers in the reference, rounded to float32 where they
meet float32 tensors (JAX's weak typing); ``TAP_WEIGHTS32`` and ``WSUM32``
are those roundings.

While a render counts (utils/stats.py), each lookup adds its lane count to
"Textures/EWA lookups" (the reference's mipmap.rs:17-19 counter).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from .. import cuda
from ..ops.mipmap import (TAP_WEIGHTS32, TAPS, WRAP_BLACK, WRAP_REPEAT,
                          WSUM, WSUM32)
from ..utils import stats as S

MAX_ANISOTROPY = 8.0




def build_atlas_meta(images: List[list]):
    """Static metadata for a list of pyramids (lists of (H, W[, C]) arrays).
    -> dict(atlas_meta (I, Lmax, 3) int32 [offset, w, h] (pad levels repeat
    the coarsest), atlas_levels (I,) int32, atlas_total), or None."""
    if not images:
        return None
    n_img = len(images)
    lmax = max(len(p) for p in images)
    meta = np.zeros((n_img, lmax, 3), np.int64)
    levels = np.zeros((n_img,), np.int32)
    off = 0
    for i, pyr in enumerate(images):
        levels[i] = len(pyr)
        for li, lv in enumerate(pyr):
            h, w = np.asarray(lv).shape[:2]
            meta[i, li] = (off, w, h)
            off += h * w
        meta[i, len(pyr):] = meta[i, len(pyr) - 1]
    if off >= 1 << 31:
        raise ValueError("atlas exceeds int32 addressing")
    return dict(atlas_meta=meta.astype(np.int32), atlas_levels=levels,
                atlas_total=int(off))


def _levels_rgb(images):
    for pyr in images:
        for lv in pyr:
            lv = torch.as_tensor(lv, dtype=torch.float32)
            if lv.dim() == 2:
                lv = lv[..., None]
            if lv.shape[-1] == 1:
                lv = lv.expand(*lv.shape[:-1], 3)
            yield lv


def atlas_texels(images: List[list]):
    """Flat (T, 3) texel array in build_atlas_meta's offset order;
    1-channel levels are replicated to 3."""
    return torch.cat([lv.reshape(-1, 3) for lv in _levels_rgb(images)])


def atlas_quad_index(images: List[list]):
    """(T, 4) int64: for each texel, the (T, 3) rows of its 2x2 bilerp
    neighbourhood [(s, t), (s+1, t), (s, t+1), (s+1, t+1)], REPEAT-wrapped
    within its level (the host-side shapes of ``images`` only)."""
    parts, off = [], 0
    for pyr in images:
        for lv in pyr:
            h, w = lv.shape[:2]
            t, s = torch.meshgrid(torch.arange(h), torch.arange(w),
                                  indexing="ij")
            s1, t1 = (s + 1) % w, (t + 1) % h
            parts.append(off + torch.stack(
                [t * w + s, t * w + s1, t1 * w + s, t1 * w + s1],
                -1).reshape(-1, 4))
            off += h * w
    return torch.cat(parts)


def atlas_quad_texels(images: List[list]):
    """(T, 12) rows [v00 v10 v01 v11]: each texel row carries its 2x2
    bilerp neighbourhood with REPEAT wrapping baked in, so a bilerp reads
    one row. Valid only when every registration wraps REPEAT."""
    texels = atlas_texels(images)
    return quad_rows(texels, atlas_quad_index(images).to(texels.device))


def quad_rows(texels, quad_index):
    """The (T, 12) quad rows of the (T, 3) ``texels``."""
    return texels[quad_index].reshape(-1, 12)


def all_repeat(regs):
    """Every registration wraps REPEAT: the quad rows' precondition."""
    return bool(np.all(np.asarray(regs["reg_wrap"]) == WRAP_REPEAT))


def build_registrations(texs):
    """Per-registration tables of a list of ImageTexture instances.
    -> dict(reg_img (K,), reg_map (K, 4) [su, sv, du, dv], reg_scale (K,),
    reg_wrap (K,)) of numpy arrays, or None."""
    k = len(texs)
    if k == 0:
        return None
    reg_img = np.zeros((k,), np.int32)
    reg_map = np.zeros((k, 4), np.float32)
    reg_scale = np.zeros((k,), np.float32)
    reg_wrap = np.zeros((k,), np.int32)
    for i, t in enumerate(texs):
        reg_img[i] = t.image_id
        m = t.mapping
        reg_map[i] = (m.su, m.sv, m.du, m.dv)
        reg_scale[i] = float(t.scale)
        reg_wrap[i] = t.wrap
    return dict(reg_img=reg_img, reg_map=reg_map, reg_scale=reg_scale,
                reg_wrap=reg_wrap)


REG_DTYPES = dict(reg_img=torch.int32, reg_map=torch.float32,
                  reg_scale=torch.float32, reg_wrap=torch.int32)


def registrations_on(regs, device):
    """The registration tables as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=REG_DTYPES[k],
                               device=device) for k, v in regs.items()}


def _texel_at(texels, off, w, h, wrap, s_i, t_i):
    """Per-lane wrapped texel gather from the flat (T, 3) atlas."""
    s_m = torch.remainder(s_i, w)
    t_m = torch.remainder(t_i, h)
    s_c = torch.minimum(torch.clamp(s_i, min=0), w - 1)
    t_c = torch.minimum(torch.clamp(t_i, min=0), h - 1)
    rep = wrap == WRAP_REPEAT
    s_f = torch.where(rep, s_m, s_c)
    t_f = torch.where(rep, t_m, t_c)
    v = texels[(off + t_f * w + s_f).long()]
    inside = (s_i >= 0) & (s_i < w) & (t_i >= 0) & (t_i < h)
    black = (wrap == WRAP_BLACK) & ~inside
    return torch.where(black[:, None], 0.0, v)


def _bilerp_setup(meta, img, li, st):
    m = meta[img.long(), li.long()]
    off, w, h = m[:, 0], m[:, 1], m[:, 2]
    s = st[:, 0] * w.float() - 0.5
    t = st[:, 1] * h.float() - 0.5
    s0 = torch.floor(s).int()
    t0 = torch.floor(t).int()
    return off, w, h, s0, t0, (s - s0)[:, None], (t - t0)[:, None]


def _bilerp_at(texels, meta, wrap, img, li, st):
    off, w, h, s0, t0, ds, dt = _bilerp_setup(meta, img, li, st)
    v00 = _texel_at(texels, off, w, h, wrap, s0, t0)
    v10 = _texel_at(texels, off, w, h, wrap, s0 + 1, t0)
    v01 = _texel_at(texels, off, w, h, wrap, s0, t0 + 1)
    v11 = _texel_at(texels, off, w, h, wrap, s0 + 1, t0 + 1)
    return (1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + \
        (1 - ds) * dt * v01 + ds * dt * v11


def _bilerp_at_quad(qtexels, meta, img, li, st):
    """One (B, 12) quad-row gather per bilerp; the arithmetic of
    _bilerp_at."""
    off, w, h, s0, t0, ds, dt = _bilerp_setup(meta, img, li, st)
    s_f = torch.remainder(s0, w)
    t_f = torch.remainder(t0, h)
    v = qtexels[(off + t_f * w + s_f).long()]
    return (1 - ds) * (1 - dt) * v[:, 0:3] + ds * (1 - dt) * v[:, 3:6] \
        + (1 - ds) * dt * v[:, 6:9] + ds * dt * v[:, 9:12]


def ewa_level(meta_levels, img, minor_len):
    """The mip level of each lane: (L - 1) + log2(minor axis), clipped to
    [0, L - 1]. -> (level f32, L int32)."""
    big_l = meta_levels[img.long()]
    top = (big_l - 1).float()
    level = top + torch.log2(torch.clamp(minor_len, min=1e-8))
    return torch.minimum(torch.clamp(level, min=0.0), top), big_l


def _ewa_axes(regs, reg, si):
    """-> (r, img, wrap, st (B, 2), major (B, 2), minor_len (B,))."""
    r = torch.clamp(reg, min=0).long()
    img = regs["reg_img"][r]
    m = regs["reg_map"][r]
    wrap = regs["reg_wrap"][r]
    su, sv = m[:, 0], m[:, 1]
    st = torch.stack([si.uv[:, 0] * su + m[:, 2],
                      si.uv[:, 1] * sv + m[:, 3]], dim=-1)
    d0s, d0t = si.dudx * su, si.dvdx * sv
    d1s, d1t = si.dudy * su, si.dvdy * sv
    len0 = torch.sqrt(torch.clamp(d0s * d0s + d0t * d0t, min=1e-24))
    len1 = torch.sqrt(torch.clamp(d1s * d1s + d1t * d1t, min=1e-24))
    major_is_0 = len0 >= len1
    major_len = torch.maximum(len0, len1)
    minor_len = torch.minimum(len0, len1)
    major = torch.where(major_is_0[:, None], torch.stack([d0s, d0t], -1),
                        torch.stack([d1s, d1t], -1))
    minor_len = torch.maximum(minor_len, major_len / MAX_ANISOTROPY)
    return r, img, wrap, st, major, minor_len


def atlas_lookup_ewa_plain(texels, meta, levels, regs, reg, si, quad=False):
    """Plain PyTorch version of K5: per-lane EWA lookup, 8 Gaussian taps
    along the major axis between two mip levels. ``regs`` holds tensors
    (``registrations_on``); lanes with reg < 0 get zeros."""
    r, img, wrap, st, major, minor_len = _ewa_axes(regs, reg, si)
    level, big_l = ewa_level(levels, img, minor_len)
    l0 = torch.floor(level).int()
    l1 = torch.minimum(l0 + 1, big_l - 1)
    dl = (level - l0)[:, None]
    out = torch.zeros((reg.shape[0], 3), dtype=torch.float32,
                      device=reg.device)
    for a, wgt in TAPS:
        st_k = st + a * major
        if quad:
            v = (1.0 - dl) * _bilerp_at_quad(texels, meta, img, l0, st_k) \
                + dl * _bilerp_at_quad(texels, meta, img, l1, st_k)
        else:
            v = (1.0 - dl) * _bilerp_at(texels, meta, wrap, img, l0, st_k) \
                + dl * _bilerp_at(texels, meta, wrap, img, l1, st_k)
        out = out + wgt * v
    out = out / WSUM * regs["reg_scale"][r][:, None]
    return torch.where((reg >= 0)[:, None], out, 0.0)


def _check_lookup(meta, levels, regs, reg, si):
    """Raise unless the lookup's tables and lanes are what K5 and K10
    read."""
    n = reg.shape[0]
    dev = reg.device
    n_img, lmax = meta.shape[0], meta.shape[1]
    cuda.check(meta, "atlas_meta", torch.int32, (n_img, lmax, 3), dev)
    cuda.check(levels, "atlas_levels", torch.int32, (n_img,), dev)
    k = regs["reg_img"].shape[0]
    for name, shape in (("reg_img", (k,)), ("reg_map", (k, 4)),
                        ("reg_scale", (k,)), ("reg_wrap", (k,))):
        cuda.check(regs[name], name, REG_DTYPES[name], shape, dev)
    cuda.check(reg, "reg", torch.int32, (n,), dev)
    cuda.check(si.uv, "uv", torch.float32, (n, 2), dev)
    for name in ("dudx", "dvdx", "dudy", "dvdy"):
        cuda.check(getattr(si, name), name, torch.float32, (n,), dev)


UV_GRAD = ("a gradient through an atlas lookup's coordinates (the "
           "interaction's uv or its differentials)")


def atlas_lookup_ewa(texels, meta, levels, regs, reg, si, quad=False):
    """EWA lookups of registrations ``reg`` (B,) int32 at the lanes of
    ``si`` (uv and the four texture differentials) -> (B, 3) float32.
    ``texels`` is the (T, 12) quad array when ``quad`` else the (T, 3)
    array; ``meta``, ``levels`` and ``regs`` are tensors on its device.
    CPU tensors take the plain version, CUDA tensors launch K5. With grad
    mode on, a uv or differential that requires grad raises (ROADMAP item
    B12)."""
    cuda.refuse_grad(UV_GRAD, [getattr(si, f) for f in SI_FIELDS])
    S.device_count("Textures/EWA lookups", reg.shape[0])
    if not cuda.use_kernel(reg):
        return atlas_lookup_ewa_plain(texels, meta, levels, regs, reg, si,
                                      quad)
    n = reg.shape[0]
    dev = reg.device
    cuda.check(texels, "texels", torch.float32,
               (texels.shape[0], 12 if quad else 3), dev, align=16)
    _check_lookup(meta, levels, regs, reg, si)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        cuda.launch("atlas_lookup_ewa", texels, int(quad), meta,
                    meta.shape[1], levels, regs["reg_img"], regs["reg_map"],
                    regs["reg_scale"], regs["reg_wrap"], reg, si.uv,
                    si.dudx, si.dvdx, si.dudy, si.dvdy, n, *TAP_WEIGHTS32,
                    WSUM32, out)
    return out


SI_FIELDS = ("uv", "dudx", "dvdx", "dudy", "dvdy")


def atlas_lookup_ewa_bwd_plain(g, texels, meta, levels, regs, reg, si,
                               quad_index=None):
    """Plain PyTorch version of K10: autograd of ``atlas_lookup_ewa_plain``
    -> the (T, 3) texel gradient for the lookups' gradient ``g`` (B, 3);
    with ``quad_index``, of the lookup on the quad rows built from
    ``texels``."""
    with torch.enable_grad():
        t = texels.detach().requires_grad_()
        quad = quad_index is not None
        out = atlas_lookup_ewa_plain(quad_rows(t, quad_index) if quad else t,
                                     meta, levels, regs, reg, si, quad)
        return torch.autograd.grad(out, t, g)[0]


def atlas_lookup_ewa_bwd(g, texels, meta, levels, regs, reg, si,
                         quad_index=None):
    """The (T, 3) texel gradient of ``atlas_lookup_ewa`` on ``texels``
    (with ``quad_index``: on their quad rows) for the lookups' gradient
    ``g`` (B, 3), contiguous. CPU tensors take the plain version, CUDA
    tensors launch K10."""
    if not cuda.use_kernel(reg):
        return atlas_lookup_ewa_bwd_plain(g, texels, meta, levels, regs, reg,
                                          si, quad_index)
    n = reg.shape[0]
    dev = reg.device
    cuda.check(g, "g", torch.float32, (n, 3), dev)
    cuda.check(texels, "texels", torch.float32, (texels.shape[0], 3), dev)
    _check_lookup(meta, levels, regs, reg, si)
    out = torch.zeros_like(texels)
    if n:
        cuda.launch("atlas_lookup_ewa_bwd", g, int(quad_index is not None),
                    meta, meta.shape[1], levels, regs["reg_img"],
                    regs["reg_map"], regs["reg_scale"], regs["reg_wrap"], reg,
                    si.uv, si.dudx, si.dvdx, si.dudy, si.dvdy, n,
                    *TAP_WEIGHTS32, WSUM32, out, texels.shape[0])
    return out


class _AtlasEWA(torch.autograd.Function):
    """K5 forward, K10 backward (gradient to the (T, 3) texels only; the
    coordinates are refused beforehand, ``atlas_lookup_ewa_grad``)."""

    @staticmethod
    def forward(ctx, texels, quad_index, meta, levels, regs, reg, si):
        quad = quad_index is not None
        with cuda.differentiable():
            out = atlas_lookup_ewa(
                quad_rows(texels, quad_index) if quad else texels, meta,
                levels, regs, reg, si, quad)
        ctx.save_for_backward(texels, quad_index, meta, levels, reg,
                              *[getattr(si, f) for f in SI_FIELDS])
        ctx.regs = regs
        return out

    @staticmethod
    def backward(ctx, g):
        texels, quad_index, meta, levels, reg, *fields = ctx.saved_tensors
        si = SimpleNamespace(**dict(zip(SI_FIELDS, fields)))
        with cuda.differentiable():
            g_tex = atlas_lookup_ewa_bwd(g.contiguous(), texels, meta, levels,
                                         ctx.regs, reg, si, quad_index)
        return (g_tex,) + (None,) * 6


def atlas_lookup_ewa_grad(texels, quad_index, meta, levels, regs, reg, si):
    """``atlas_lookup_ewa`` differentiable in ``texels`` (T, 3): on the
    quad rows ``texels[quad_index]`` when ``quad_index`` ((T, 4),
    ``atlas_quad_index``) is given, else on ``texels``. Forward K5,
    backward K10 (their plain versions for CPU tensors). A uv or
    differential that requires grad raises (ROADMAP item B12): the
    Function carries no gradient to them."""
    cuda.refuse_grad(UV_GRAD, [getattr(si, f) for f in SI_FIELDS])
    return _AtlasEWA.apply(texels, quad_index, meta, levels, regs, reg, si)
