"""Shadow rays and the light-sampling half of MIS direct lighting (port of
rustracer_tpu/integrators/common.py: unoccluded, estimate_direct_light_side)."""
from __future__ import annotations

import torch

from ..core.math import absdot, offset_ray_origin
from ..core.ray import Ray
from ..core.sampling import power_heuristic
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..scene import lights as L
from ..scene.tables import scene_intersect_p


def unoccluded(geom, si, ls: L.LightSample, mask):
    """Shadow ray from si to the sampled light point; lanes with mask False
    trace a zero-length ray, which the traversal treats as done."""
    o = offset_ray_origin(si.p, si.p_error, si.n, ls.wi)
    p_t = offset_ray_origin(ls.p_target, ls.err_target, ls.n_target,
                            o - ls.p_target)
    t_max = torch.where(mask, 1.0 - 1e-3, 0.0).to(torch.float32)
    return ~scene_intersect_p(geom, Ray(o=o, d=p_t - o, t_max=t_max))


def estimate_direct_light_side(ctx, mat_set, si, lobes, lid, u_light,
                               sel_pmf):
    """NEE toward light ``lid`` with MIS weight against the BSDF density
    over ``mat_set``'s lobe types; the light-selection pmf is folded into
    the light pdf. -> (B, 3)."""
    types = mat_set.types_present()
    ls = L.sample_li(ctx.lights, lid, si, u_light)
    light_pdf = ls.pdf * sel_pmf
    f = B.bsdf_f(lobes, si, si.wo, ls.wi, types) \
        * absdot(ls.wi, si.ns)[:, None]
    scattering_pdf = B.bsdf_pdf(lobes, si, si.wo, ls.wi, types)
    possible = (light_pdf > 0.0) & ~is_black(ls.li) & ~is_black(f) & si.valid
    vis = unoccluded(ctx.geom, si, ls, possible) & possible
    li = torch.where(vis[:, None], ls.li, 0.0)
    weight = power_heuristic(1.0, light_pdf, 1.0, scattering_pdf)
    pdf_safe = torch.where(possible, torch.clamp(light_pdf, min=1e-12), 1.0)
    return torch.where(possible[:, None],
                       f * li * (weight / pdf_safe)[:, None], 0.0)
