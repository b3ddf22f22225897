"""Normal (debug) integrator: grey |d . ns| of the camera ray's hit (port
of rustracer_tpu/integrators/normal.py; the reference's
integrator/normal.rs:20-34)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import absdot
from ..scene.tables import scene_intersect


@dataclasses.dataclass(frozen=True)
class NormalIntegrator:
    mat_set: object = None

    def li(self, ctx, ray, lanes, sampler, dims):
        """-> (B, 3): |d . ns| on every channel, 0 where the ray missed;
        the shading normal bumped where the material has a bump map."""
        si = scene_intersect(ctx.geom, ray)
        if self.mat_set is not None:
            si, _ = self.mat_set.shade(si, ctx)
        v = torch.where(si.valid, absdot(ray.d, si.ns), 0.0)
        return torch.stack([v, v, v], -1)
