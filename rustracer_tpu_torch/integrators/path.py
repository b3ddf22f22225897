"""Path integrator: NEE + MIS path tracing over masked wavefronts (port of
rustracer_tpu/integrators/path.py).

The bounce loop is a Python loop over full-width lane batches with alive
masks. Like the reference it uses merged MIS: the path's own bounce ray is
the BSDF-side sample, and an emitter it hits is weighted by the power
heuristic against the light-sampling density pmf * pdf_li. Sampler
dimensions are allocated exactly as the reference allocates them, so lanes
compare one to one with it.

Not ported: the alive-first slab compaction of the interior bounces (its
results are identical; it is a later performance change), passes through
medium interfaces, infinite lights, the light grid and the stats counters.
No transmissive lobe is ported, so Russian roulette's eta scale is 1.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.interaction import compute_differentials
from ..core.math import absdot
from ..core.ray import Ray
from ..core.sampling import power_heuristic
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..scene import lights as L
from ..scene.tables import scene_intersect
from .common import estimate_direct_light_side

RR_THRESHOLD = 1.0   # Russian roulette only for throughput below this


@dataclasses.dataclass
class _PathState:
    ray_o: torch.Tensor       # (B, 3)
    ray_d: torch.Tensor       # (B, 3)
    ray_tmax: torch.Tensor    # (B,)
    L: torch.Tensor           # (B, 3) accumulated radiance
    beta: torch.Tensor        # (B, 3) path throughput
    alive: torch.Tensor       # (B,) bool
    prev_pdf: torch.Tensor    # (B,) BSDF pdf of ray_d (solid angle)
    prev_spec: torch.Tensor   # (B,) bool: ray_d came from a delta lobe
    prev_p: torch.Tensor      # (B, 3) scattering point that spawned ray_d


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    mat_set: object
    max_depth: int = 5

    def li(self, ctx, ray: Ray, lanes, sampler, dims):
        return self._run(ctx, ray, lanes, sampler, dims)

    def _pick_light(self, ctx, sampler, lanes, d_sel):
        """Uniform light selection -> (light row, pmf)."""
        u_sel = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_sel)
        n = ctx.lights.n_lights
        lid = torch.clamp((u_sel * n).int(), max=n - 1)
        return lid, torch.full_like(u_sel, 1.0 / n)

    def _hit_and_emit(self, ctx, ray: Ray, st: _PathState, first: bool):
        """Closest hit and MIS-weighted emission -> (si, state)."""
        lt = ctx.lights
        si = scene_intersect(ctx.geom, ray)
        if first:
            si = compute_differentials(si, ray)
        si = dataclasses.replace(si, valid=si.valid & st.alive)
        le = L.arealight_le(lt, si.arealight, si.n, si.wo)
        if first:
            w_hit = torch.ones_like(st.prev_pdf)
        else:
            lpdf = L.pdf_li_hit(lt, si.arealight, st.prev_p, ray.d, si.p,
                                si.n) * (1.0 / lt.n_lights)
            w_hit = torch.where(st.prev_spec, 1.0,
                                power_heuristic(1.0, st.prev_pdf, 1.0, lpdf))
        le = torch.where((si.valid & (si.arealight >= 0))[:, None],
                         w_hit[:, None] * le, 0.0)
        alive = st.alive & si.valid & (si.material >= 0)
        return si, dataclasses.replace(st, L=st.L + st.beta * le, alive=alive)

    def _scatter(self, ctx, sampler, lanes, si, st: _PathState,
                 d_sel, d_light, d_lobe, d_u2, d_rr, rr_on: bool):
        """Shade, NEE (light side), BSDF bounce sample, Russian roulette."""
        lobes = self.mat_set.shade(si, ctx.textures)
        lobes = lobes._replace(active=lobes.active & st.alive[:, None])
        n_nonspec = B.num_matching(lobes, B.ALL & ~B.SPECULAR)
        lid, pmf = self._pick_light(ctx, sampler, lanes, d_sel)
        u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_light)
        ld = estimate_direct_light_side(ctx, si, lobes, lid, u_light, pmf)
        Lrad = st.L + torch.where((st.alive & (n_nonspec > 0))[:, None],
                                  st.beta * ld, 0.0)

        u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_lobe)
        u2 = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_u2)
        wi, f, pdf, flags, ok = B.bsdf_sample_f(lobes, si, si.wo, u_lobe, u2)
        contrib = f * (absdot(wi, si.ns)
                       / torch.clamp(pdf, min=1e-12))[:, None]
        alive = st.alive & ok & ~is_black(f) & (pdf > 0.0)
        beta = torch.where(alive[:, None], st.beta * contrib, st.beta)
        ray = si.spawn_ray(wi)
        # dead lanes must not traverse
        t_max = torch.where(alive, ray.t_max, 0.0)

        # Russian roulette; its dimension is allocated on every bounce
        if rr_on:
            u_rr = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_rr)
            rr_beta_max = beta.max(dim=-1).values
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            do_rr = rr_beta_max < RR_THRESHOLD
            alive = alive & ~(do_rr & (u_rr < q))
            beta = torch.where((do_rr & alive)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-3)[:, None],
                               beta)
        return _PathState(ray_o=ray.o, ray_d=ray.d, ray_tmax=t_max, L=Lrad,
                          beta=beta, alive=alive, prev_pdf=pdf,
                          prev_spec=(flags & B.SPECULAR) != 0, prev_p=si.p)

    def _run(self, ctx, ray: Ray, lanes, sampler, dims):
        """Radiance (B, 3) of the camera rays."""
        n = ray.t_max.shape[0]
        dev = ray.o.device
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        st = _PathState(
            ray_o=ray.o, ray_d=ray.d, ray_tmax=ray.t_max,
            L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            # prev_spec True: weight-1 emission on camera hits
            prev_pdf=ones, prev_spec=torch.ones(n, dtype=torch.bool,
                                                device=dev),
            prev_p=ray.o)
        si, st = self._hit_and_emit(ctx, ray, st, first=True)
        if self.max_depth == 1:
            return st.L
        st = self._scatter(ctx, sampler, lanes, si, st, dims.next_1d(),
                           dims.next_2d(), dims.next_1d(), dims.next_2d(),
                           dims.next_1d(), rr_on=False)
        # interior bounces 1..max_depth-2, dims laid out as the reference's
        # scanned body allocates them
        base1, base2 = dims.d1, dims.d2
        n_interior = max(self.max_depth - 2, 0)
        dims.d1 += 3 * n_interior
        dims.d2 += 2 * n_interior
        for b in range(1, self.max_depth - 1):
            k = b - 1
            r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
            si, st = self._hit_and_emit(ctx, r, st, first=False)
            st = self._scatter(ctx, sampler, lanes, si, st,
                               base1 + 3 * k, base2 + 2 * k,
                               base1 + 3 * k + 1, base2 + 2 * k + 1,
                               base1 + 3 * k + 2, rr_on=b > 3)
        # final bounce: emission only
        r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
        _, st = self._hit_and_emit(ctx, r, st, first=False)
        return st.L
