"""Shadow rays, MIS direct lighting and the specular tree (port of
rustracer_tpu/integrators/common.py: unoccluded, estimate_direct,
estimate_direct_light_side, uniform_sample_one_light,
uniform_sample_all_lights, specular_diff_ray, trace_specular_tree).
``unoccluded`` and ``estimate_direct_light_side`` are made of
ops/pathchain.py ``shadow_ray`` and ``light_side_terms``, which the plain
twin of hand kernel K22 (ops/pathshade.py) shares.

``estimate_direct`` traces its BSDF-sampled ray before it asks the light
for that direction's density (scene/lights.py ``pdf_li`` reads the ray's
closest hit where the reference intersects the light's own shape): the
ray is traced on the lanes that may contribute, and a lane whose light
density is 0 adds nothing, as in the reference.

``trace_specular_tree`` visits the deterministic reflect and transmit
branches depth first, one wavefront of the caller's lanes a node, and
skips a subtree where no lane lives. Every node draws its sampler
dimensions from a base of its own, laid out as the reference lays out
its tree in preorder (a node's direct lighting first, then its reflect
subtree, then its transmit subtree), so lanes compare one to one with
the JAX package.
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
from ..ops.pathchain import light_side_terms, shadow_ray
from ..scene import lights as L
from ..scene.tables import scene_intersect, scene_intersect_p


def unoccluded(geom, si, ls: L.LightSample, mask):
    """(B,) bool: ``shadow_ray`` reaches its target unblocked."""
    return ~scene_intersect_p(geom, shadow_ray(si, ls, mask))


def estimate_direct_light_side(ctx, mat_set, si, lobes, lid, u_light,
                               sel_pmf):
    """NEE toward light ``lid`` (``light_side_terms``) -> ((B, 3)
    radiance, (B,) bool: the lanes whose shadow ray was traced, the
    reference's observed shadow tests)."""
    ls, f, w_pdf, possible = light_side_terms(
        ctx.lights, mat_set.types_present(), si, lobes, lid, u_light, sel_pmf)
    vis = unoccluded(ctx.geom, si, ls, possible) & possible
    li = torch.where(vis[:, None], ls.li, 0.0)
    return torch.where(possible[:, None], f * li * w_pdf[:, None],
                       0.0), possible


def estimate_direct(ctx, mat_set, si, lobes, lid, u_light, u_scatter_lobe,
                    u_scatter, kinds=None):
    """MIS direct lighting from light row ``lid`` (B,): the light's sample
    and the BSDF's non-specular sample, each weighted by the power
    heuristic (the reference's integrator/mod.rs:222-318). ``kinds``: the
    light kinds the lanes' rows take (scene/lights.py sample_li). -> (B, 3)
    radiance, not times the path's throughput."""
    types = mat_set.types_present()
    flags = B.ALL & ~B.SPECULAR
    geom, lt = ctx.geom, ctx.lights

    # the light's sample
    ls = L.sample_li(lt, lid, si, u_light, kinds)
    f = B.bsdf_f(lobes, si, si.wo, ls.wi, types, flags) \
        * absdot(ls.wi, si.ns)[:, None]
    scattering_pdf = B.bsdf_pdf(lobes, si, si.wo, ls.wi, types, flags)
    possible = (ls.pdf > 0.0) & ~is_black(ls.li) & ~is_black(f) & si.valid
    vis = unoccluded(geom, si, ls, possible) & possible
    li = torch.where(vis[:, None], ls.li, 0.0)
    weight = power_heuristic(1.0, ls.pdf, 1.0, scattering_pdf)
    if ls.is_delta is not None:
        weight = torch.where(ls.is_delta, 1.0, weight)
    # the double where on the divisor: a masked lane's pdf may be 0
    pdf_safe = torch.where(possible, torch.clamp(ls.pdf, min=1e-12), 1.0)
    ld = torch.where(possible[:, None],
                     f * li * (weight / pdf_safe)[:, None], 0.0)
    if not lt.l_nondelta_rows:
        # every light a point or distant light: no BSDF sample hits one
        return ld

    # the BSDF's sample, traced on the lanes that may contribute
    wi_b, f_b, pdf_b, _, ok_b = B.bsdf_sample_f(lobes, si, si.wo,
                                                u_scatter_lobe, u_scatter,
                                                types, flags)
    f_b = f_b * absdot(wi_b, si.ns)[:, None]
    do_bsdf = ok_b & ~is_black(f_b) & (pdf_b > 0.0) & si.valid
    if ls.is_delta is not None:
        do_bsdf = do_bsdf & ~ls.is_delta
    ray_b = si.spawn_ray(wi_b)
    ray_b = dataclasses.replace(ray_b, t_max=torch.where(do_bsdf,
                                                         ray_b.t_max, 0.0))
    si_b = scene_intersect(geom, ray_b)
    hit_light = si_b.valid & (si_b.arealight == lid)
    light_pdf = L.pdf_li(lt, lid, si.p, wi_b, si_b.p, si_b.n, hit_light)
    # no specular sample (flags): the power heuristic throughout, and no
    # contribution where the light's density is 0
    do_bsdf = do_bsdf & (light_pdf > 0.0)
    w_b = power_heuristic(1.0, pdf_b, 1.0, light_pdf)
    li_b = torch.where(hit_light[:, None],
                       L.arealight_le(lt, si_b.arealight, si_b.n, -wi_b),
                       0.0)
    if lt.has_infinite:
        li_b = li_b + L.infinite_le_one(lt, lid, wi_b.contiguous(),
                                        ~si_b.valid & do_bsdf)
    pdf_b_safe = torch.where(do_bsdf, torch.clamp(pdf_b, min=1e-12), 1.0)
    return ld + torch.where(do_bsdf[:, None],
                            f_b * li_b * (w_b / pdf_b_safe)[:, None], 0.0)


def uniform_sample_one_light(ctx, mat_set, si, lobes, sampler, lanes, dims):
    """One light picked uniformly, its estimate times the light count
    (integrator/mod.rs:186-220)."""
    n = ctx.lights.n_lights
    u_sel = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, dims.next_1d())
    lid = torch.clamp((u_sel * n).int(), max=n - 1)
    u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx,
                             dims.next_2d())
    u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx, dims.next_1d())
    u_sc = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx, dims.next_2d())
    return estimate_direct(ctx, mat_set, si, lobes, lid, u_light, u_lobe,
                           u_sc) * float(n)


def uniform_sample_all_lights(ctx, mat_set, si, lobes, sampler, lanes, dims,
                              nsamples=None):
    """Every light, each the average of its ``nsamples`` estimates (the
    per-row counts, aligned with the light rows; None: one each), summed
    (integrator/mod.rs:145-184)."""
    lt = ctx.lights
    total = torch.zeros_like(si.p)
    for i in range(lt.n_lights):
        ns = max(1, int(nsamples[i])) if nsamples is not None \
            and i < len(nsamples) else 1
        lid = torch.full_like(si.material, i)
        kinds = L.row_kinds(lt, i)
        acc = torch.zeros_like(si.p)
        for _ in range(ns):
            u_light = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx,
                                     dims.next_2d())
            u_lobe = sampler.get_1d(lanes.pixel_idx, lanes.sample_idx,
                                    dims.next_1d())
            u_sc = sampler.get_2d(lanes.pixel_idx, lanes.sample_idx,
                                  dims.next_2d())
            acc = acc + estimate_direct(ctx, mat_set, si, lobes, lid,
                                        u_light, u_lobe, u_sc, kinds)
        total = total + acc / float(ns)
    return total


def specular_diff_ray(ray: Ray, si, wi, eta, transmit: bool) -> Ray:
    """The specular continuation ray from si along wi, its differentials
    carried through the mirror or the refraction (integrator/mod.rs:49-142,
    with the dmu/dx term PBRT-v3 uses where the Rust reference's binding
    was dead)."""
    r = si.spawn_ray(wi)
    if not ray.has_differentials:
        return r
    ns, wo = si.ns, si.wo
    dndx = si.dndu * si.dudx[:, None] + si.dndv * si.dvdx[:, None]
    dndy = si.dndu * si.dudy[:, None] + si.dndv * si.dvdy[:, None]
    dwodx = -ray.rx_direction - wo
    dwody = -ray.ry_direction - wo
    ddndx = dot(dwodx, ns) + dot(wo, dndx)
    ddndy = dot(dwody, ns) + dot(wo, dndy)
    if not transmit:
        won = dot(wo, ns)[:, None]
        rx_d = wi - dwodx + 2.0 * (won * dndx + ddndx[:, None] * ns)
        ry_d = wi - dwody + 2.0 * (won * dndy + ddndy[:, None] * ns)
    else:
        e = torch.where(dot(wo, ns) < 0.0,
                        1.0 / torch.clamp(eta, min=1e-8), eta)
        wn = dot(-wo, ns)
        win = dot(wi, ns)
        mu = e * wn - win
        dmu = e - (e * e * wn) / torch.where(torch.abs(win) > 1e-8, win, 1.0)
        dmudx = dmu * ddndx
        dmudy = dmu * ddndy
        rx_d = wi + e[:, None] * dwodx - (mu[:, None] * dndx
                                          + dmudx[:, None] * ns)
        ry_d = wi + e[:, None] * dwody - (mu[:, None] * dndy
                                          + dmudy[:, None] * ns)
    return dataclasses.replace(r, rx_origin=si.p + si.dpdx,
                               ry_origin=si.p + si.dpdy, rx_direction=rx_d,
                               ry_direction=ry_d)


class _OffsetDims:
    """A node's sampler dimensions: next_1d / next_2d from its own bases,
    counting what it takes (k1, k2)."""

    def __init__(self, base1: int, base2: int):
        self.base1, self.base2 = base1, base2
        self.k1 = self.k2 = 0

    def next_1d(self):
        self.k1 += 1
        return self.base1 + self.k1 - 1

    def next_2d(self):
        self.k2 += 1
        return self.base2 + self.k2 - 1


def _tree_nodes(depth: int, branches: int) -> int:
    """Nodes of a full tree of ``depth`` levels with ``branches`` children
    a node."""
    return sum(branches ** i for i in range(depth))


def trace_specular_tree(ctx, mat_set, ray, lanes, sampler, dims, max_depth,
                        direct_fn):
    """Emitted plus direct lighting (``direct_fn(si, lobes, dims)``) at
    each node, then the deterministic specular reflect and transmit
    branches down to ``max_depth`` levels (whitted.rs:87-97, the
    reference's recursive specular_reflection / specular_transmission):
    a tree of 2^depth - 1 nodes where both branch kinds are present, a
    chain where one is, the root alone where none is (types_present). ->
    (B, 3) radiance."""
    types = mat_set.types_present()
    lt = ctx.lights
    has_refl = B.SPECULAR_REFL in types or B.FRESNEL_SPECULAR in types
    has_trans = B.SPECULAR_TRANS in types or B.FRESNEL_SPECULAR in types
    branches = int(has_refl) + int(has_trans)
    node_dims = [0, 0]

    def node(ray, depth, live, b1, b2):
        si = scene_intersect(ctx.geom, ray)
        si = compute_differentials(si, ray)
        Lrad = torch.zeros_like(ray.o)
        if lt.has_infinite:
            Lrad = L.infinite_le(lt, ray.d.contiguous(), live & ~si.valid)
        alive = live & si.valid & (si.material >= 0)
        le = L.arealight_le(lt, si.arealight, si.n, si.wo)
        Lrad = Lrad + torch.where(alive[:, None], le, 0.0)
        si_s, lobes = mat_set.shade(si, ctx)
        lobes = lobes._replace(active=lobes.active & alive[:, None])
        od = _OffsetDims(b1, b2)
        Lrad = Lrad + torch.where(alive[:, None], direct_fn(si_s, lobes, od),
                                  0.0)
        node_dims[:] = od.k1, od.k2
        if depth + 1 >= max_depth:
            return Lrad
        c1, c2 = od.k1, od.k2
        # dims of a child subtree's nodes: the transmit child's base skips
        # the reflect child's subtree
        sub = _tree_nodes(max_depth - depth - 1, branches) if has_refl else 0
        for transmit, present in ((False, has_refl), (True, has_trans)):
            if not present:
                continue
            branch = B.specular_transmit_branch if transmit \
                else B.specular_reflect_branch
            wi, wgt, ok = branch(lobes, si_s, si_s.wo, types)
            live_c = alive & ok & (wgt > 0.0).any(-1)
            if not bool(live_c.any()):
                continue
            r = specular_diff_ray(ray, si_s, wi, lobes.eta, transmit)
            r = dataclasses.replace(r, t_max=torch.where(live_c, r.t_max,
                                                         0.0))
            skip = sub if transmit else 0
            sub_l = node(r, depth + 1, live_c, b1 + c1 + c1 * skip,
                         b2 + c2 + c2 * skip)
            Lrad = Lrad + torch.where(live_c[:, None], wgt * sub_l, 0.0)
        return Lrad

    out = node(ray, 0, torch.ones_like(ray.t_max, dtype=torch.bool),
               dims.d1, dims.d2)
    # the caller's dims move past the whole tree's, as the reference's do
    n_tree = _tree_nodes(max_depth, branches) if branches else 1
    dims.d1 += node_dims[0] * n_tree
    dims.d2 += node_dims[1] * n_tree
    return out
