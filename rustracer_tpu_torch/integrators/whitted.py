"""Whitted integrator (port of rustracer_tpu/integrators/whitted.py; the
reference's integrator/whitted.rs:41-99): emitted light, every light's
one unweighted sample tested for occlusion, and the deterministic specular
reflect and transmit tree with ray differentials (common.py
trace_specular_tree)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import absdot
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..scene import lights as L
from .common import trace_specular_tree, unoccluded


@dataclasses.dataclass(frozen=True)
class WhittedIntegrator:
    mat_set: object
    max_depth: int = 5

    def li(self, ctx, ray, lanes, sampler, dims):
        types = self.mat_set.types_present()
        lt = ctx.lights

        def direct(si, lobes, dims):
            """Every light, one sample, no MIS (whitted.rs:60-85)."""
            total = torch.zeros_like(si.p)
            for i in range(lt.n_lights):
                lid = torch.full_like(si.material, i)
                u = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx,
                                   dims.next_2d())
                ls = L.sample_li(lt, lid, si, u, L.row_kinds(lt, i))
                f = B.bsdf_f(lobes, si, si.wo, ls.wi, types) \
                    * absdot(ls.wi, si.ns)[:, None]
                possible = (ls.pdf > 0.0) & ~is_black(ls.li) & ~is_black(f)
                vis = unoccluded(ctx.geom, si, ls, possible) & possible
                pdf_safe = torch.where(possible,
                                       torch.clamp(ls.pdf, min=1e-12), 1.0)
                total = total + torch.where(
                    vis[:, None], f * ls.li / pdf_safe[:, None], 0.0)
            return total

        return trace_specular_tree(ctx, self.mat_set, ray, lanes, sampler,
                                   dims, self.max_depth, direct)
