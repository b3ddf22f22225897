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

A scene whose materials are each one Lambertian lobe under triangle
lights alone takes the kernel route (``kernel_route``, decided at each
trace): the emission after each closest hit is hand kernel K21, and the
scatter after the shading is K22 (the NEE up to its shadow ray, the
bounce, Russian roulette), the shadow ray's any hit, and K23 (the NEE's
radiance added where unoccluded), ops/pathshade.py. Their plain twins and
this chain are made of the same pieces (ops/pathchain.py), so on the CPU
the route computes the same bits; a train step (a texture leaf that
requires grad) keeps the general chain.

A hit on a medium interface (a prim with neither material nor area
light) is passed through without spending a bounce, up to
``max_interface_skips`` times (scene/tables.py
scene_intersect_passthrough; a scene without interfaces intersects once).

``li_aux`` returns the radiance and each lane's path length (the bounces
that hit a surface, the reference's path.rs:18-19 distribution), and
while a device tape of utils/stats.py is open each closest-hit call adds
its regular intersection tests (the lanes with t_max > 0: on a slab
bounce, the slab's) and each NEE its shadow tests (the lanes whose shadow
ray was traced) as device scalars: the reference's observed counters
(scene.rs:9-20), with no host sync. ``tests_per_lane`` gives the
dispatched bounds beside them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.interaction import compute_differentials
from ..core.math import dot
from ..core.ray import Ray
from ..ops import bsdf as B
from ..ops import compact as C
from ..ops import pathchain as PC
from ..ops import pathshade as PS
from ..scene import lightdistrib as LD
from ..scene import lights as L
from ..scene.tables import scene_intersect_p, scene_intersect_passthrough
from ..utils import stats as S
from .common import estimate_direct_light_side

REGULAR_TESTS = "Intersections/Regular ray intersection tests (observed)"
SHADOW_TESTS = "Intersections/Shadow ray intersection tests (observed)"

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
    path_len: torch.Tensor    # (B,) int32 bounces that hit a surface


# state fields moved into and out of a slab (pixel and sample indices move
# in besides, and come back unchanged)
SLAB_FIELDS = ("ray_o", "ray_d", "ray_tmax", "L", "beta", "eta_scale",
               "alive", "prev_pdf", "prev_spec", "prev_p", "path_len")


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    mat_set: object
    max_depth: int = 5
    rr_threshold: float = 1.0   # Russian roulette for throughput below this
    max_interface_skips: int = 8
    # alive-first slab compaction of the interior bounces; compact_tiers 1
    # offers the B/2 slab only, 2 adds the B/4 slab
    compact_interior: bool = True
    compact_tiers: int = 2

    def li(self, ctx, ray: Ray, lanes, sampler, dims):
        return self._run(ctx, ray, lanes, sampler, dims)

    def li_aux(self, ctx, ray: Ray, lanes, sampler, dims):
        """-> (radiance (B, 3), path length (B,) int32)."""
        st = self._trace(ctx, ray, lanes, sampler, dims)
        return st.L, st.path_len

    def tests_per_lane(self):
        """Intersection tests a camera ray dispatches at most: one closest
        hit a bounce, one shadow ray a NEE (the JAX package's bounds)."""
        return {"regular": self.max_depth, "shadow": self.max_depth - 1}

    def kernel_route(self, ctx) -> bool:
        """True when this scene's chain runs as hand kernels K21-K23
        (ops/pathshade.py): one Lambertian lobe a material (matte
        surfaces), every light a triangle light, and no texture leaf of
        ``ctx`` requiring grad while grad mode is on (the train steps keep
        the general chain)."""
        return (self.mat_set.types_present() == PS.LAMBERT
                and self.mat_set.max_lobes == 1
                and ctx.lights.kinds <= {"tri"}
                and not (torch.is_grad_enabled()
                         and _requires_grad(ctx.textures)))

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

    def _hit_and_emit(self, ctx, ray: Ray, st: _PathState, first: bool,
                      route: bool = False):
        """Closest hit and MIS-weighted emission -> (si, state); on the
        kernel route the emission is K21."""
        lt = ctx.lights
        if S.counting():
            S.device_count(REGULAR_TESTS, (ray.t_max > 0.0).sum())
        si = scene_intersect_passthrough(ctx.geom, ray,
                                         self.max_interface_skips)
        if first:
            si = compute_differentials(si, ray)
        pmf = None if first else self._sel_pmf(ctx, st.prev_p, si.arealight)
        if route:
            valid, Lrad, alive, path_len = PS.path_hit_emit(
                lt, si, ray.d, st, pmf, first)
            return dataclasses.replace(si, valid=valid), dataclasses.replace(
                st, L=Lrad, alive=alive, path_len=path_len)
        si = dataclasses.replace(si, valid=si.valid & st.alive)
        le = PC.hit_emission(lt, si, ray.d, st, pmf, first, si.valid)
        if lt.has_infinite:
            le = le + self._escape(ctx, ray, st, si, first)
        alive = st.alive & si.valid & (si.material >= 0)
        return si, dataclasses.replace(st, L=st.L + st.beta * le, alive=alive,
                                       path_len=st.path_len + alive)

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
                 d_sel, d_light, d_lobe, d_u2, d_rr, rr_on: bool,
                 route: bool = False):
        """Shade, NEE (light side), BSDF bounce sample, Russian roulette;
        on the kernel route K22, the shadow ray's any hit and K23."""
        if route:
            return self._scatter_lambert(ctx, sampler, lanes, si, st, d_sel,
                                         d_light, d_lobe, d_u2, d_rr, rr_on)
        types = self.mat_set.types_present()
        si, lobes = self.mat_set.shade(si, ctx)
        lobes = lobes._replace(active=lobes.active & st.alive[:, None])
        n_nonspec = B.num_matching(lobes, B.ALL & ~B.SPECULAR)
        lid, pmf = self._pick_light(ctx, sampler, lanes, si, d_sel)
        u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_light)
        ld, traced = estimate_direct_light_side(ctx, self.mat_set, si, lobes,
                                                lid, u_light, pmf)
        if S.counting():
            S.device_count(SHADOW_TESTS, traced.sum())
        Lrad = st.L + torch.where((st.alive & (n_nonspec > 0))[:, None],
                                  st.beta * ld, 0.0)

        u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_lobe)
        u2 = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, d_u2)
        b = PC.bsdf_bounce(si, lobes, st.alive, st.beta, u_lobe, u2, types)
        alive, beta = b.alive, b.beta
        spec = (b.flags & B.SPECULAR) != 0
        eta_scale = st.eta_scale
        if B.FRESNEL_SPECULAR in types or B.SPECULAR_TRANS in types:
            eta2 = lobes.eta * lobes.eta
            eta_scale = torch.where(
                spec & ((b.flags & B.TRANSMISSION) != 0),
                eta_scale * torch.where(dot(si.wo, si.ns) > 0.0, eta2,
                                        1.0 / torch.clamp(eta2, min=1e-8)),
                eta_scale)

        # Russian roulette; its dimension is allocated on every bounce
        if rr_on:
            u_rr = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, d_rr)
            alive, beta = PC.russian_roulette(beta, eta_scale, alive, u_rr,
                                              self.rr_threshold)
        return _PathState(ray_o=b.ray_o, ray_d=b.wi, ray_tmax=b.t_max,
                          L=Lrad, beta=beta, eta_scale=eta_scale,
                          alive=alive, prev_pdf=b.pdf, prev_spec=spec,
                          prev_p=si.p, path_len=st.path_len)

    def _scatter_lambert(self, ctx, sampler, lanes, si, st: _PathState,
                         d_sel, d_light, d_lobe, d_u2, d_rr, rr_on: bool):
        """``_scatter`` on the kernel route: shade, the light pick, the
        sampler's draws, then K22, the shadow ray's any hit and K23."""
        si, lobes = self.mat_set.shade(si, ctx)
        lid, pmf = self._pick_light(ctx, sampler, lanes, si, d_sel)
        pix, smp = lanes.pixel_idx, lanes.sample_idx
        u_light = sampler.get_2d(pix, smp, d_light)
        u_lobe = sampler.get_1d(pix, smp, d_lobe)
        u2 = sampler.get_2d(pix, smp, d_u2)
        u_rr = sampler.get_1d(pix, smp, d_rr) if rr_on else None
        sc = PS.path_scatter_lambert(ctx.lights, si, lobes, st, lid, pmf,
                                     u_light, u_lobe, u2, u_rr,
                                     self.rr_threshold)
        if S.counting():
            S.device_count(SHADOW_TESTS, (sc.shadow_tmax > 0.0).sum())
        occluded = scene_intersect_p(ctx.geom, Ray(
            o=sc.shadow_o, d=sc.shadow_d, t_max=sc.shadow_tmax))
        return _PathState(ray_o=sc.ray_o, ray_d=sc.ray_d,
                          ray_tmax=sc.ray_tmax,
                          L=PS.path_nee_add(st.L, sc.pending, occluded),
                          beta=sc.beta, eta_scale=st.eta_scale,
                          alive=sc.alive, prev_pdf=sc.prev_pdf,
                          prev_spec=sc.prev_spec, prev_p=si.p,
                          path_len=st.path_len)

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
            prev_p=ray.o,
            path_len=torch.zeros(n, dtype=torch.int32, device=dev))

    def bounce0(self, ctx, ray: Ray, lanes, sampler, dims,
                route=None) -> _PathState:
        """Camera hit, emission and the bounce-0 scatter: the state whose
        alive mask picks the slab width of the interior bounces
        (``route``: ``kernel_route(ctx)`` when None)."""
        if route is None:
            route = self.kernel_route(ctx)
        si, st = self._hit_and_emit(ctx, ray, self._initial_state(ray),
                                    first=True, route=route)
        return self._scatter(ctx, sampler, lanes, si, st, dims.next_1d(),
                             dims.next_2d(), dims.next_1d(), dims.next_2d(),
                             dims.next_1d(), rr_on=False, route=route)

    def _run(self, ctx, ray: Ray, lanes, sampler, dims):
        """Radiance (B, 3) of the camera rays."""
        return self._trace(ctx, ray, lanes, sampler, dims).L

    def _trace(self, ctx, ray: Ray, lanes, sampler, dims):
        """The final path state of the camera rays."""
        route = self.kernel_route(ctx)
        if self.max_depth == 1:
            _, st = self._hit_and_emit(ctx, ray, self._initial_state(ray),
                                       first=True, route=route)
            return st
        st = self.bounce0(ctx, ray, lanes, sampler, dims, route)
        # interior bounces 1..max_depth-2, dims laid out as the reference's
        # scanned body allocates them
        base1, base2 = dims.d1, dims.d2
        n_interior = max(self.max_depth - 2, 0)
        dims.d1 += 3 * n_interior
        dims.d2 += 2 * n_interior
        if n_interior:
            st = self._interior(ctx, sampler, lanes, st, base1, base2, route)
        # final bounce: emission only
        r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
        _, st = self._hit_and_emit(ctx, r, st, first=False, route=route)
        return st

    def _bounces(self, ctx, sampler, lanes, st, base1, base2, route):
        for b in range(1, self.max_depth - 1):
            k = b - 1
            r = Ray(o=st.ray_o, d=st.ray_d, t_max=st.ray_tmax)
            si, st = self._hit_and_emit(ctx, r, st, first=False, route=route)
            st = self._scatter(ctx, sampler, lanes, si, st,
                               base1 + 3 * k, base2 + 2 * k,
                               base1 + 3 * k + 1, base2 + 2 * k + 1,
                               base1 + 3 * k + 2, rr_on=b > 3, route=route)
        return st

    def slab_width(self, n, n_alive):
        """The interior's lane count: n/4 or n/2 when the alive lanes fit."""
        if self.compact_tiers >= 2 and n % 4 == 0 and n_alive <= n // 4:
            return n // 4
        return n // 2 if n_alive <= n // 2 else n

    def _interior(self, ctx, sampler, lanes, st, base1, base2, route):
        """Interior bounces at full width or on an alive-first slab."""
        n = st.alive.shape[0]
        if not (self.compact_interior and n >= PATH_COMPACT_MIN_B
                and n % 2 == 0):
            return self._bounces(ctx, sampler, lanes, st, base1, base2,
                                 route)
        order, _rank, n_alive = C.alive_first_order(st.alive)
        w = self.slab_width(n, int(n_alive.item()))
        TIERS[n // w] += 1
        if w == n:
            return self._bounces(ctx, sampler, lanes, st, base1, base2,
                                 route)
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
        sub_st = self._bounces(ctx, sampler, sub_lanes, sub_st, base1, base2,
                               route)
        # the slab's lanes go back into the full-width state in place: the
        # tensors of st were made by this step's bounce-0 scatter (under
        # autograd the put marks them dirty)
        full = C.slab_put(full, [getattr(sub_st, f) for f in SLAB_FIELDS],
                          order, w)
        return _PathState(**dict(zip(SLAB_FIELDS, full)))


def _requires_grad(tree) -> bool:
    """A float tensor of the dicts, lists and tuples ``tree`` requires
    grad."""
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad
