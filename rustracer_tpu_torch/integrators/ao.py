"""Ambient-occlusion integrator (port of rustracer_tpu/integrators/ao.py;
the reference's integrator/ao.rs:32-58): ``n_samples`` cosine-weighted
occlusion probes over the hemisphere of the camera ray's hit, around the
shading normal (bumped where the material has a bump map: the hit is
shaded first, as the reference computes the scattering functions)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import face_forward
from ..core.sampling import cosine_sample_hemisphere
from ..scene.tables import scene_intersect, scene_intersect_p


@dataclasses.dataclass(frozen=True)
class AOIntegrator:
    mat_set: object = None
    n_samples: int = 16

    def li(self, ctx, ray, lanes, sampler, dims):
        """-> (B, 3): the unoccluded share of the probes on every channel,
        0 where the camera ray missed."""
        si = scene_intersect(ctx.geom, ray)
        if self.mat_set is not None:
            si, _ = self.mat_set.shade(si, ctx)
        n = face_forward(si.ns, si.wo)
        occ = torch.zeros_like(si.t)
        for _ in range(self.n_samples):
            u = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx,
                               dims.next_2d())
            w_local = cosine_sample_hemisphere(u)
            w = w_local[:, 0, None] * si.ss + w_local[:, 1, None] * si.ts \
                + w_local[:, 2, None] * n
            shadow = si.spawn_ray(w)
            shadow = dataclasses.replace(shadow, t_max=torch.where(
                si.valid, shadow.t_max, 0.0))
            occ = occ + torch.where(scene_intersect_p(ctx.geom, shadow),
                                    0.0, 1.0)
        v = torch.where(si.valid, occ / self.n_samples, 0.0)
        return torch.stack([v, v, v], -1)
