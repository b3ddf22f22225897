"""The pieces of the path integrator's per-bounce chain that its general
form (integrators/path.py ``_hit_and_emit`` and ``_scatter``,
integrators/common.py ``unoccluded`` and ``estimate_direct_light_side``)
and the plain twins of hand kernels K21-K23 (ops/pathshade.py) share, so
that the twins compute the general chain's bits:

- ``hit_emission``: the closest hit's MIS-weighted area-light emission;
- ``light_side_terms``: NEE's light sample, f, MIS weight over the pdf
  and the mask of lanes that may add, before the shadow ray;
- ``shadow_ray``: the ray toward that sample (both offset_ray_origin's);
- ``bsdf_bounce``: the BSDF-sampled bounce, the throughput and spawn_ray;
- ``russian_roulette``.

Ports of rustracer_tpu/integrators/path.py ``_hit_and_emit`` (:190) and
``_scatter`` (:230) and rustracer_tpu/integrators/common.py
``unoccluded`` and ``estimate_direct_light_side`` (:97), cut where the
kernels cut them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import INFINITY, absdot, offset_ray_origin
from ..core.ray import Ray
from ..core.sampling import power_heuristic
from ..core.spectrum import is_black
from ..scene import lights as L
from . import bsdf as B


class Bounce(NamedTuple):
    """The BSDF-sampled bounce of a scatter (``bsdf_bounce``)."""
    wi: torch.Tensor       # (B, 3) world direction
    pdf: torch.Tensor      # (B,)
    flags: torch.Tensor    # (B,) the sampled lobe's flags
    alive: torch.Tensor    # (B,) bool
    beta: torch.Tensor     # (B, 3) throughput times f |cos| / pdf
    ray_o: torch.Tensor    # (B, 3) the spawned ray's origin
    t_max: torch.Tensor    # (B,) infinity, 0 on dead lanes


def hit_emission(lt, si, d, st, pmf, first, valid):
    """The area-light emission of the closest hit ``si`` of rays with
    directions ``d`` (B, 3) on the lanes ``valid``, weighted by the power
    heuristic of ``st.prev_pdf`` against the light density ``pdf_li_hit``
    times ``pmf`` (the selection pmf at ``st.prev_p``: a number or (B,)),
    1 where ``st.prev_spec`` or on camera rays (``first``) -> (B, 3)."""
    le = L.arealight_le(lt, si.arealight, si.n, si.wo)
    if first:
        w_hit = torch.ones_like(st.prev_pdf)
    else:
        lpdf = L.pdf_li_hit(lt, si.arealight, st.prev_p, d, si.p,
                            si.n) * pmf
        w_hit = torch.where(st.prev_spec, 1.0,
                            power_heuristic(1.0, st.prev_pdf, 1.0, lpdf))
    return torch.where((valid & (si.arealight >= 0))[:, None],
                       w_hit[:, None] * le, 0.0)


def light_side_terms(lt, types, si, lobes, lid, u_light, sel_pmf):
    """The light's sample of NEE toward light row ``lid`` of ``lt`` before
    its shadow ray: -> (ls, f (B, 3) times |cos|, the MIS weight over the
    pdf (B,), possible (B,) bool). The weight is the power heuristic
    against the BSDF density over the lobe types ``types`` (1 toward a
    point or distant light, which no bounce ray hits); the
    light-selection pmf (B,) or a number is folded into the light pdf."""
    ls = L.sample_li(lt, lid, si, u_light)
    light_pdf = ls.pdf * sel_pmf
    f = B.bsdf_f(lobes, si, si.wo, ls.wi, types) \
        * absdot(ls.wi, si.ns)[:, None]
    scattering_pdf = B.bsdf_pdf(lobes, si, si.wo, ls.wi, types)
    possible = (light_pdf > 0.0) & ~is_black(ls.li) & ~is_black(f) & si.valid
    weight = power_heuristic(1.0, light_pdf, 1.0, scattering_pdf)
    if ls.is_delta is not None:
        weight = torch.where(ls.is_delta, 1.0, weight)
    pdf_safe = torch.where(possible, torch.clamp(light_pdf, min=1e-12), 1.0)
    return ls, f, weight / pdf_safe, possible


def shadow_ray(si, ls: L.LightSample, mask) -> Ray:
    """Shadow ray from si to the sampled light point, or, toward a distant
    or infinite light (``ls.at_infinity``), along wi with t_max = INFINITY
    and the target not offset; lanes with mask False get a zero-length
    ray, which the traversal treats as done."""
    o = offset_ray_origin(si.p, si.p_error, si.n, ls.wi)
    p_t = offset_ray_origin(ls.p_target, ls.err_target, ls.n_target,
                            o - ls.p_target)
    if ls.at_infinity is None:
        t_max = torch.where(mask, 1.0 - 1e-3, 0.0).to(torch.float32)
        return Ray(o=o, d=p_t - o, t_max=t_max)
    at_inf = ls.at_infinity
    t_max = torch.where(mask, torch.where(at_inf, INFINITY, 1.0 - 1e-3),
                        0.0).to(torch.float32)
    d = torch.where(at_inf[:, None], ls.wi, p_t - o)
    return Ray(o=o, d=d, t_max=t_max)


def bsdf_bounce(si, lobes, alive, beta, u_lobe, u2, types) -> Bounce:
    """The bounce of the path integrator's scatter: ``bsdf_sample_f``'s
    direction, the throughput update, ``spawn_ray`` and the dead lanes'
    t_max 0."""
    wi, f, pdf, flags, ok = B.bsdf_sample_f(lobes, si, si.wo, u_lobe, u2,
                                            types)
    contrib = f * (absdot(wi, si.ns)
                   / torch.clamp(pdf, min=1e-12))[:, None]
    alive = alive & ok & ~is_black(f) & (pdf > 0.0)
    beta = torch.where(alive[:, None], beta * contrib, beta)
    ray = si.spawn_ray(wi)
    # dead lanes must not traverse
    t_max = torch.where(alive, ray.t_max, 0.0)
    return Bounce(wi, pdf, flags, alive, beta, ray.o, t_max)


def russian_roulette(beta, eta_scale, alive, u_rr, threshold):
    """Russian roulette on the throughput times ``eta_scale`` below
    ``threshold`` -> (alive, beta)."""
    rr_beta_max = (beta * eta_scale[:, None]).max(dim=-1).values
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    do_rr = rr_beta_max < threshold
    alive = alive & ~(do_rr & (u_rr < q))
    beta = torch.where((do_rr & alive)[:, None],
                       beta / torch.clamp(1.0 - q, min=1e-3)[:, None], beta)
    return alive, beta
