"""Direct-lighting integrator (port of rustracer_tpu/integrators/direct.py;
the reference's integrator/directlighting.rs:17-144): MIS direct lighting
from every light (strategy "all", each light averaging its own sample
count) or from one picked uniformly ("one"), over the deterministic
specular reflect and transmit tree (common.py trace_specular_tree)."""
from __future__ import annotations

import dataclasses

from .common import (trace_specular_tree, uniform_sample_all_lights,
                     uniform_sample_one_light)


@dataclasses.dataclass(frozen=True)
class DirectLightingIntegrator:
    mat_set: object
    strategy: str = "all"      # "all" | "one"
    max_depth: int = 5
    # sample counts aligned with the light rows (the lights' "nsamples");
    # (): one sample a light
    light_nsamples: tuple = ()

    def li(self, ctx, ray, lanes, sampler, dims):
        def direct(si, lobes, dims):
            if self.strategy == "all":
                return uniform_sample_all_lights(
                    ctx, self.mat_set, si, lobes, sampler, lanes, dims,
                    self.light_nsamples or None)
            return uniform_sample_one_light(ctx, self.mat_set, si, lobes,
                                            sampler, lanes, dims)

        return trace_specular_tree(ctx, self.mat_set, ray, lanes, sampler,
                                   dims, self.max_depth, direct)
