"""Path integrator: NEE + MIS path tracing over masked wavefronts (port of
rustracer_tpu/integrators/path.py).

The bounce loop is a Python loop over full-width lane batches with alive
masks. Like the reference it uses merged MIS: the path's own bounce ray is
the BSDF-side sample, and an emitter it hits is weighted by the power
heuristic against the light-sampling density pmf * pdf_li. Sampler
dimensions are allocated exactly as the reference allocates them, so lanes
compare one to one with it.

Wavefronts of at least ``PATH_COMPACT_MIN_B`` lanes run the interior
bounces on an alive-first slab (hand kernels K6 and K7, ops/compact.py):
after bounce 0 the alive count picks the slab width once, B/4 when at most a
quarter of the lanes live, B/2 when at most half, else the full width. Dead
lanes are never read again (their radiance is final and every update is
masked by alive), so the results equal the full-width run's up to float
rounding. The choice is a host decision: one ``n_alive.item()`` per step.

Lights are picked uniformly, or, when ``ctx.light_grid`` is set, through
the spatial light grid (scene/lightdistrib.py, hand kernel K13): the pick
at the scattering point and the emission-hit MIS weight's selection pmf at
the point the ray left (``prev_p``).

A ray that leaves the scene under infinite lights adds their radiance
(scene/lights.py, hand kernel K16): a camera ray at weight 1, a bounce
ray (and the final emission-only bounce) weighted by the power heuristic
against each infinite light's sampling density times its selection pmf at
``prev_p`` (1/n for the uniform pick, K13's lookup under the grid). A
scene without an infinite light runs none of this.

Russian roulette reads the throughput times ``eta_scale``, the product
of the squared relative IORs of the specular transmissions taken.

Not ported: passes through medium interfaces and the stats counters.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.interaction import compute_differentials
from ..core.math import absdot, dot
from ..core.ray import Ray
from ..core.sampling import power_heuristic
from ..core.spectrum import is_black
from ..ops import bsdf as B
from ..ops import compact as C
from ..scene import lightdistrib as LD
from ..scene import lights as L
from ..scene.tables import scene_intersect
from .common import estimate_direct_light_side

# wavefronts at least this wide may run the interior bounces on a slab
PATH_COMPACT_MIN_B = 1 << 16

# interior runs per slab width divisor (1 full, 2 half, 4 quarter), counted
# since the last reset_tiers()
TIERS = {1: 0, 2: 0, 4: 0}


def reset_tiers():
    for k in TIERS:
        TIERS[k] = 0


@dataclasses.dataclass
class _PathState:
    ray_o: torch.Tensor       # (B, 3)
    ray_d: torch.Tensor       # (B, 3)
    ray_tmax: torch.Tensor    # (B,)
    L: torch.Tensor           # (B, 3) accumulated radiance
    beta: torch.Tensor        # (B, 3) path throughput
    eta_scale: torch.Tensor   # (B,) squared IOR ratios of specular refractions
    alive: torch.Tensor       # (B,) bool
    prev_pdf: torch.Tensor    # (B,) BSDF pdf of ray_d (solid angle)
    prev_spec: torch.Tensor   # (B,) bool: ray_d came from a delta lobe
    prev_p: torch.Tensor      # (B, 3) scattering point that spawned ray_d


# state fields moved into and out of a slab (pixel and sample indices move
# in besides, and come back unchanged)
SLAB_FIELDS = ("ray_o", "ray_d", "ray_tmax", "L", "beta", "eta_scale",
               "alive", "prev_pdf", "prev_spec", "prev_p")


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    mat_set: object
    max_depth: int = 5
    rr_threshold: float = 1.0   # Russian roulette for throughput below this
    # alive-first slab compaction of the interior bounces; compact_tiers 1
    # offers the B/2 slab only, 2 adds the B/4 slab
    compact_interior: bool = True
    compact_tiers: int = 2

    def li(self, ctx, ray: Ray, lanes, sampler, dims):
        return self._run(ctx, ray, lanes, sampler, dims)

    def _pick_light(self, ctx, sampler, lanes, si, d_sel):
        """Light selection at the scattering point -> (light row, pmf):
        uniform, or through the spatial grid."""
        u_sel = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_sel)
        if getattr(ctx, "light_grid", None) is not None:
            return LD.sample_light(ctx.light_grid, si.p.contiguous(), u_sel)
        n = ctx.lights.n_lights
        lid = torch.clamp((u_sel * n).int(), max=n - 1)
        return lid, torch.full_like(u_sel, 1.0 / n)

    def _sel_pmf(self, ctx, p, lid):
        """Selection pmf of light row ``lid`` for a path scattered at p:
        the density the emission-hit MIS weight pairs with the pick (the
        uniform pick's 1/n as a number)."""
        if getattr(ctx, "light_grid", None) is not None:
            return LD.pmf_lookup(ctx.light_grid, p.contiguous(),
                                 lid.int().contiguous())
        return 1.0 / ctx.lights.n_lights

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
                                si.n) * self._sel_pmf(ctx, st.prev_p,
                                                      si.arealight)
            w_hit = torch.where(st.prev_spec, 1.0,
                                power_heuristic(1.0, st.prev_pdf, 1.0, lpdf))
        le = torch.where((si.valid & (si.arealight >= 0))[:, None],
                         w_hit[:, None] * le, 0.0)
        if lt.has_infinite:
            le = le + self._escape(ctx, ray, st, si, first)
        alive = st.alive & si.valid & (si.material >= 0)
        return si, dataclasses.replace(st, L=st.L + st.beta * le, alive=alive)

    def _escape(self, ctx, ray: Ray, st: _PathState, si, first: bool):
        """The infinite lights' radiance on the lanes whose ray escaped
        (alive, no hit): weight 1 on camera rays, else MIS against each
        light's density times its selection pmf at prev_p (K16)."""
        lt = ctx.lights
        escaped = st.alive & ~si.valid
        d = ray.d.contiguous()
        if first:
            return L.infinite_le(lt, d, escaped)
        if getattr(ctx, "light_grid", None) is None:
            pmfs = [1.0 / lt.n_lights] * lt.n_infinite
        else:
            pmfs = [self._sel_pmf(ctx, st.prev_p, torch.full(
                escaped.shape, row, dtype=torch.int32, device=d.device))
                for row in lt.inf_rows]
        return L.infinite_le_mis(lt, d, st.prev_pdf.contiguous(),
                                 st.prev_spec.contiguous(), pmfs, escaped)

    def _scatter(self, ctx, sampler, lanes, si, st: _PathState,
                 d_sel, d_light, d_lobe, d_u2, d_rr, rr_on: bool):
        """Shade, NEE (light side), BSDF bounce sample, Russian roulette."""
        types = self.mat_set.types_present()
        si, lobes = self.mat_set.shade(si, ctx)
        lobes = lobes._replace(active=lobes.active & st.alive[:, None])
        n_nonspec = B.num_matching(lobes, B.ALL & ~B.SPECULAR)
        lid, pmf = self._pick_light(ctx, sampler, lanes, si, d_sel)
        u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_light)
        ld = estimate_direct_light_side(ctx, self.mat_set, si, lobes, lid,
                                        u_light, pmf)
        Lrad = st.L + torch.where((st.alive & (n_nonspec > 0))[:, None],
                                  st.beta * ld, 0.0)

        u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_lobe)
        u2 = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_u2)
        wi, f, pdf, flags, ok = B.bsdf_sample_f(lobes, si, si.wo, u_lobe, u2,
                                                types)
        contrib = f * (absdot(wi, si.ns)
                       / torch.clamp(pdf, min=1e-12))[:, None]
        alive = st.alive & ok & ~is_black(f) & (pdf > 0.0)
        beta = torch.where(alive[:, None], st.beta * contrib, st.beta)
        spec = (flags & B.SPECULAR) != 0
        eta_scale = st.eta_scale
        if B.FRESNEL_SPECULAR in types or B.SPECULAR_TRANS in types:
            eta2 = lobes.eta * lobes.eta
            eta_scale = torch.where(
                spec & ((flags & B.TRANSMISSION) != 0),
                eta_scale * torch.where(dot(si.wo, si.ns) > 0.0, eta2,
                                        1.0 / torch.clamp(eta2, min=1e-8)),
                eta_scale)
        ray = si.spawn_ray(wi)
        # dead lanes must not traverse
        t_max = torch.where(alive, ray.t_max, 0.0)

        # Russian roulette; its dimension is allocated on every bounce
        if rr_on:
            u_rr = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_rr)
            rr_beta_max = (beta * eta_scale[:, None]).max(dim=-1).values
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            do_rr = rr_beta_max < self.rr_threshold
            alive = alive & ~(do_rr & (u_rr < q))
            beta = torch.where((do_rr & alive)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-3)[:, None],
                               beta)
        return _PathState(ray_o=ray.o, ray_d=ray.d, ray_tmax=t_max, L=Lrad,
                          beta=beta, eta_scale=eta_scale, alive=alive,
                          prev_pdf=pdf, prev_spec=spec, prev_p=si.p)

    @staticmethod
    def _initial_state(ray: Ray) -> _PathState:
        """The path state of camera rays ``ray`` before bounce 0."""
        n = ray.t_max.shape[0]
        dev = ray.o.device
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        return _PathState(
            ray_o=ray.o, ray_d=ray.d, ray_tmax=ray.t_max,
            L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
            eta_scale=torch.ones(n, dtype=torch.float32, device=dev),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            # prev_spec True: weight-1 emission on camera hits
            prev_pdf=ones, prev_spec=torch.ones(n, dtype=torch.bool,
                                                device=dev),
            prev_p=ray.o)

    def bounce0(self, ctx, ray: Ray, lanes, sampler, dims) -> _PathState:
        """Camera hit, emission and the bounce-0 scatter: the state whose
        alive mask picks the slab width of the interior bounces."""
        si, st = self._hit_and_emit(ctx, ray, self._initial_state(ray),
                                    first=True)
        return self._scatter(ctx, sampler, lanes, si, st, dims.next_1d(),
                             dims.next_2d(), dims.next_1d(), dims.next_2d(),
                             dims.next_1d(), rr_on=False)

    def _run(self, ctx, ray: Ray, lanes, sampler, dims):
        """Radiance (B, 3) of the camera rays."""
        if self.max_depth == 1:
            _, st = self._hit_and_emit(ctx, ray, self._initial_state(ray),
                                       first=True)
            return st.L
        st = self.bounce0(ctx, ray, lanes, sampler, dims)
        # interior bounces 1..max_depth-2, dims laid out as the reference's
        # scanned body allocates them
        base1, base2 = dims.d1, dims.d2
        n_interior = max(self.max_depth - 2, 0)
        dims.d1 += 3 * n_interior
        dims.d2 += 2 * n_interior
        if n_interior:
            st = self._interior(ctx, sampler, lanes, st, base1, base2)
        # final bounce: emission only
        r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
        _, st = self._hit_and_emit(ctx, r, st, first=False)
        return st.L

    def _bounces(self, ctx, sampler, lanes, st, base1, base2):
        for b in range(1, self.max_depth - 1):
            k = b - 1
            r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
            si, st = self._hit_and_emit(ctx, r, st, first=False)
            st = self._scatter(ctx, sampler, lanes, si, st,
                               base1 + 3 * k, base2 + 2 * k,
                               base1 + 3 * k + 1, base2 + 2 * k + 1,
                               base1 + 3 * k + 2, rr_on=b > 3)
        return st

    def slab_width(self, n, n_alive):
        """The interior's lane count: n/4 or n/2 when the alive lanes fit."""
        if self.compact_tiers >= 2 and n % 4 == 0 and n_alive <= n // 4:
            return n // 4
        return n // 2 if n_alive <= n // 2 else n

    def _interior(self, ctx, sampler, lanes, st, base1, base2):
        """Interior bounces at full width or on an alive-first slab."""
        n = st.alive.shape[0]
        if not (self.compact_interior and n >= PATH_COMPACT_MIN_B
                and n % 2 == 0):
            return self._bounces(ctx, sampler, lanes, st, base1, base2)
        order, _rank, n_alive = C.alive_first_order(st.alive)
        w = self.slab_width(n, int(n_alive.item()))
        TIERS[n // w] += 1
        if w == n:
            return self._bounces(ctx, sampler, lanes, st, base1, base2)
        full = [getattr(st, f).contiguous() for f in SLAB_FIELDS]
        if torch.is_grad_enabled() and (st.L.requires_grad
                                        or st.beta.requires_grad):
            # the graph has saved some of these tensors (the alive mask as
            # a where condition): the put below writes into copies
            full = [f.clone() for f in full]
        sub = C.slab_take(full + [lanes.pixel_idx.contiguous(),
                                  lanes.sample_idx.contiguous()], order, w)
        k = len(SLAB_FIELDS)
        sub_st = _PathState(**dict(zip(SLAB_FIELDS, sub[:k])))
        sub_lanes = dataclasses.replace(lanes, pixel_idx=sub[k],
                                        sample_idx=sub[k + 1])
        sub_st = self._bounces(ctx, sampler, sub_lanes, sub_st, base1, base2)
        # the slab's lanes go back into the full-width state in place: the
        # tensors of st were made by this step's bounce-0 scatter (under
        # autograd the put marks them dirty)
        full = C.slab_put(full, [getattr(sub_st, f) for f in SLAB_FIELDS],
                          order, w)
        return _PathState(**dict(zip(SLAB_FIELDS, full)))

