"""Lobe-stack BSDF evaluation (port of rustracer_tpu/ops/bsdf.py, the
Lambertian reflection lobe).

Every lane carries up to M lobes as (type, params[16], active) rows; f and
pdf sum or average the active matching lobes, and sampling picks the k-th
matching lobe. Params slot [0:3] is the lobe's color.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import INV_PI, dot
from ..core.sampling import cosine_sample_hemisphere

LAMBERTIAN_REFL = 0

REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL = REFLECTION | TRANSMISSION | DIFFUSE | GLOSSY | SPECULAR

LOBE_FLAGS = {LAMBERTIAN_REFL: REFLECTION | DIFFUSE}


class LobeStack(NamedTuple):
    type: torch.Tensor     # (B, M) int32
    params: torch.Tensor   # (B, M, 16) float32
    active: torch.Tensor   # (B, M) bool


def lobe_flags(ltype):
    """Flags per lobe type (every ported type is Lambertian)."""
    return torch.full_like(ltype, LOBE_FLAGS[LAMBERTIAN_REFL])


def _matches(ltype, flags):
    lf = lobe_flags(ltype)
    return (lf & flags) == lf


def world_to_local(ss, ts, ns, v):
    return torch.stack([dot(v, ss), dot(v, ts), dot(v, ns)], dim=-1)


def local_to_world(ss, ts, ns, v):
    return v[..., 0, None] * ss + v[..., 1, None] * ts + v[..., 2, None] * ns


def num_matching(lobes: LobeStack, flags):
    m = lobes.active & _matches(lobes.type, flags)
    return m.sum(-1, dtype=torch.int32)


def _lambert_f(params, wo, wi):
    same = wo[..., 2] * wi[..., 2] > 0.0
    return torch.where(same[..., None], params[..., 0:3] * INV_PI, 0.0)


def _lambert_pdf(wo, wi):
    same = wo[..., 2] * wi[..., 2] > 0.0
    return torch.where(same, torch.abs(wi[..., 2]) * INV_PI, 0.0)


def bsdf_f(lobes: LobeStack, si, wo_w, wi_w, flags=ALL):
    """Sum of the matching lobes' f, with the geometric-normal
    reflect/transmit test."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = torch.abs(wo[..., 2]) > 1e-8
    reflect_w = dot(wi_w, si.n) * dot(wo_w, si.n) > 0.0
    lf = lobe_flags(lobes.type)
    hemi_ok = torch.where(reflect_w[..., None], (lf & REFLECTION) != 0,
                          (lf & TRANSMISSION) != 0)
    m = lobes.active & _matches(lobes.type, flags) & hemi_ok
    f = _lambert_f(lobes.params, wo[..., None, :], wi[..., None, :])
    f = torch.where(m[..., None], f, 0.0).sum(-2)
    return torch.where(ok_wo[..., None], f, 0.0)


def bsdf_pdf(lobes: LobeStack, si, wo_w, wi_w, flags=ALL):
    """Average of the matching lobes' pdf."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    wi = world_to_local(si.ss, si.ts, si.ns, wi_w)
    ok_wo = torch.abs(wo[..., 2]) > 1e-8
    m = lobes.active & _matches(lobes.type, flags)
    pdf = torch.where(m, _lambert_pdf(wo[..., None, :], wi[..., None, :]),
                      0.0)
    n = m.sum(-1, dtype=torch.int32)
    out = pdf.sum(-1) / torch.clamp(n.float(), min=1.0)
    return torch.where(ok_wo & (n > 0), out, 0.0)


def bsdf_sample_f(lobes: LobeStack, si, wo_w, u_lobe, u2, flags=ALL):
    """Sample a direction from the k-th matching lobe, k = floor(u_lobe *
    n_match). -> (wi_w, f (B,3), pdf (B,), sampled flags (B,), valid)."""
    wo = world_to_local(si.ss, si.ts, si.ns, wo_w)
    m = lobes.active & _matches(lobes.type, flags)
    n_match = m.sum(-1, dtype=torch.int32)
    k = torch.minimum((u_lobe * n_match.float()).int(),
                      torch.clamp(n_match - 1, min=0))
    rank = torch.cumsum(m.int(), dim=-1) - 1
    chosen = torch.argmax((m & (rank == k[..., None])).int(), dim=-1)
    ct = torch.gather(lobes.type, -1, chosen[..., None])[..., 0]
    u = torch.stack([torch.clamp(u2[..., 0], max=0.99999), u2[..., 1]], -1)
    # diffuse lobes: cosine-weighted hemisphere on wo's side
    w = cosine_sample_hemisphere(u)
    wi = torch.where((wo[..., 2] < 0.0)[..., None],
                     w * w.new_tensor([1.0, 1.0, -1.0]), w)
    wi_w = local_to_world(si.ss, si.ts, si.ns, wi)
    f = bsdf_f(lobes, si, wo_w, wi_w, flags)
    pdf = bsdf_pdf(lobes, si, wo_w, wi_w, flags)
    valid = (n_match > 0) & (torch.abs(wo[..., 2]) > 1e-8) & (pdf > 0.0)
    return (wi_w, torch.where(valid[..., None], f, 0.0),
            torch.where(valid, pdf, 0.0), lobe_flags(ct), valid)
