"""The path integrator's per-bounce chain for Lambertian surfaces under
triangle area lights: hand kernels K21-K23 (csrc/pathshade.cu) and their
plain twins.

They replace the chain of rustracer_tpu/integrators/path.py
``_hit_and_emit`` (:190) and ``_scatter`` (:230) around the closest hit
(K1, K2), the shading (``MaterialSet.shade``: K5, K8) and the shadow ray's
any hit (K1), for a scene whose materials are each one LAMBERTIAN_REFL
lobe and whose lights are all triangle area lights (integrators/path.py
decides):

- K21 ``path_hit_emit``: the hit's emission (scene/lights.py
  ``arealight_le``), weighted on a bounce ray by the power heuristic of
  the BSDF pdf against ``pdf_li_hit`` times the selection pmf (1 after a
  specular bounce or on a camera ray), added to L times beta; the hit's
  valid mask, the path's alive mask and length.
- K22 ``path_scatter_lambert``: next-event estimation toward the picked
  triangle light (``sample_li``'s triangle row, ops/bsdf.py ``bsdf_f`` and
  ``bsdf_pdf`` of the Lambertian lobe, the power heuristic) up to its
  shadow ray (ops/pathchain.py ``shadow_ray``), whose radiance
  ``pending`` waits on the any hit; the cosine-hemisphere bounce
  (``bsdf_sample_f``), the throughput, ``spawn_ray`` and Russian
  roulette: every field of the path state but L.
- K23 ``path_nee_add``: L plus the pending radiance where the shadow ray
  found no occluder, so that L takes the emission first and the NEE
  second, as the plain chain adds them.

Each plain twin is the port's chain as it was, made of the functions
named above (the pieces the general chain shares are ops/pathchain.py's),
so on the CPU the route computes what the general chain computes, bit
for bit. A CUDA tensor launches the kernel; the twins run on
the card only inside ``cuda.plain_reference()``. No gradient flows
through the kernels: the wrappers refuse a tensor that requires grad
(ROADMAP.md, section B, item B1.1), and the train steps take the general
chain.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cuda
from . import bsdf as B
from .pathchain import (bsdf_bounce, hit_emission, light_side_terms,
                        russian_roulette, shadow_ray)

# the lobe types of the route (one lobe a material)
LAMBERT = (B.LAMBERTIAN_REFL,)
# the ROADMAP item that carries the kernels' backward
GRAD_ITEM = "B1.1"


class Scatter(NamedTuple):
    """K22's outputs: the next path state but L, the shadow ray and the
    NEE radiance that waits on it."""
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    ray_tmax: torch.Tensor
    beta: torch.Tensor
    alive: torch.Tensor
    prev_pdf: torch.Tensor
    prev_spec: torch.Tensor
    shadow_o: torch.Tensor
    shadow_d: torch.Tensor
    shadow_tmax: torch.Tensor
    pending: torch.Tensor


# ---------------------------------------------------------------------------
# K21 path_hit_emit
# ---------------------------------------------------------------------------

def path_hit_emit_plain(lt, si, d, st, pmf=None, first=False):
    """Plain twin of K21: ``hit_emission`` on the hits of live paths added
    to the path state ``st``'s L times beta. -> (valid (B,) bool: the hit
    on a live path, L, alive, path_len)."""
    valid = si.valid & st.alive
    le = hit_emission(lt, si, d, st, pmf, first, valid)
    alive = st.alive & valid & (si.material >= 0)
    return valid, st.L + st.beta * le, alive, st.path_len + alive


def path_hit_emit(lt, si, d, st, pmf=None, first=False):
    """K21 (csrc/pathshade.cu): ``path_hit_emit_plain``'s outputs. CPU
    tensors take the plain twin, CUDA tensors launch the kernel."""
    cuda.refuse_grad("K21 path_hit_emit's gradient",
                     (si.n, si.wo, si.p, d, st.L, st.beta, st.prev_pdf,
                      st.prev_p, pmf), GRAD_ITEM)
    if not cuda.use_kernel(st.L):
        return path_hit_emit_plain(lt, si, d, st, pmf, first)
    n, dev = st.L.shape[0], st.L.device
    _check_lights(lt, dev)
    args = [_lane(si.valid, "si.valid", torch.bool, (n,), dev),
            _lane(si.arealight, "si.arealight", torch.int32, (n,), dev),
            _lane(si.material, "si.material", torch.int32, (n,), dev)]
    args += [_lane(t, name, torch.float32, (n, 3), dev) for t, name in (
        (si.n, "si.n"), (si.wo, "si.wo"), (si.p, "si.p"), (d, "d"),
        (st.L, "L"), (st.beta, "beta"), (st.prev_p, "prev_p"))]
    args += [_lane(st.alive, "alive", torch.bool, (n,), dev),
             _lane(st.prev_pdf, "prev_pdf", torch.float32, (n,), dev),
             _lane(st.prev_spec, "prev_spec", torch.bool, (n,), dev),
             _lane(st.path_len, "path_len", torch.int32, (n,), dev)]
    pmf_tab, pmf_const = _pmf_arg(pmf, n, dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    L_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    alive = torch.empty_like(valid)
    path_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        cuda.launch("path_hit_emit", *args, pmf_tab, pmf_const, int(first),
                    n, lt.n_lights, lt.l_twosided, lt.l_emit, lt.l_area,
                    valid, L_out, alive, path_len)
    return valid, L_out, alive, path_len


# ---------------------------------------------------------------------------
# K22 path_scatter_lambert
# ---------------------------------------------------------------------------

def path_scatter_lambert_plain(lt, si, lobes, st, lid, pmf, u_light, u_lobe,
                               u2, u_rr=None, rr_threshold=1.0) -> Scatter:
    """Plain twin of K22: the scatter of the path state ``st`` at the
    shaded hit (``si``, ``lobes``: one Lambertian lobe a lane) toward light row
    ``lid`` of ``lt`` (triangle lights only) picked with ``pmf`` (B,) or a
    number, with the sampler's draws ``u_light`` (B, 2), ``u_lobe`` (B,),
    ``u2`` (B, 2) and, where Russian roulette runs, ``u_rr`` (B,).
    -> ``Scatter``: the next state's ray, beta, alive, prev_pdf and
    prev_spec (its L, eta_scale, prev_p = si.p and path_len are the
    caller's), the shadow ray and the NEE radiance beta * ld it adds to L
    where the ray is unoccluded (0 where the plain chain adds 0)."""
    lobes = lobes._replace(active=lobes.active & st.alive[:, None])
    n_nonspec = B.num_matching(lobes, B.ALL & ~B.SPECULAR)
    ls, f, w_pdf, possible = light_side_terms(lt, LAMBERT, si, lobes, lid,
                                              u_light, pmf)
    shadow = shadow_ray(si, ls, possible)
    ld = torch.where(possible[:, None], f * ls.li * w_pdf[:, None], 0.0)
    pending = torch.where((st.alive & (n_nonspec > 0))[:, None],
                          st.beta * ld, 0.0)
    b = bsdf_bounce(si, lobes, st.alive, st.beta, u_lobe, u2, LAMBERT)
    alive, beta = b.alive, b.beta
    if u_rr is not None:
        alive, beta = russian_roulette(beta, st.eta_scale, alive, u_rr,
                                       rr_threshold)
    return Scatter(ray_o=b.ray_o, ray_d=b.wi, ray_tmax=b.t_max, beta=beta,
                   alive=alive, prev_pdf=b.pdf,
                   prev_spec=(b.flags & B.SPECULAR) != 0,
                   shadow_o=shadow.o, shadow_d=shadow.d,
                   shadow_tmax=shadow.t_max, pending=pending)


def path_scatter_lambert(lt, si, lobes, st, lid, pmf, u_light, u_lobe, u2,
                         u_rr=None, rr_threshold=1.0) -> Scatter:
    """K22 (csrc/pathshade.cu): ``path_scatter_lambert_plain``'s outputs.
    CPU tensors take the plain twin, CUDA tensors launch the kernel."""
    frame = (si.p, si.p_error, si.n, si.ns, si.ss, si.ts, si.wo)
    cuda.refuse_grad("K22 path_scatter_lambert's gradient",
                     frame + (lobes.params, st.beta, st.eta_scale, pmf,
                              u_light, u_lobe, u2, u_rr), GRAD_ITEM)
    if not cuda.use_kernel(st.beta):
        return path_scatter_lambert_plain(lt, si, lobes, st, lid, pmf,
                                          u_light, u_lobe, u2, u_rr,
                                          rr_threshold)
    n, dev = st.beta.shape[0], st.beta.device
    _check_lights(lt, dev)
    names = ("si.p", "si.p_error", "si.n", "si.ns", "si.ss", "si.ts", "si.wo")
    args = [_lane(t, name, torch.float32, (n, 3), dev)
            for t, name in zip(frame, names)]
    args += [_lane(si.valid, "si.valid", torch.bool, (n,), dev),
             _lane(lobes.params, "lobes.params", torch.float32, (n, 1, 16),
                   dev),
             _lane(lobes.active, "lobes.active", torch.bool, (n, 1), dev),
             _lane(st.alive, "alive", torch.bool, (n,), dev),
             _lane(st.beta, "beta", torch.float32, (n, 3), dev),
             _lane(st.eta_scale, "eta_scale", torch.float32, (n,), dev),
             _lane(lid, "lid", torch.int32, (n,), dev)]
    args += list(_pmf_arg(pmf, n, dev))
    # no u_lobe: it picks the one lobe
    args += [_lane(u_light, "u_light", torch.float32, (n, 2), dev),
             _lane(u2, "u2", torch.float32, (n, 2), dev),
             None if u_rr is None
             else _lane(u_rr, "u_rr", torch.float32, (n,), dev),
             float(rr_threshold)]
    v3 = [torch.empty((n, 3), dtype=torch.float32, device=dev)
          for _ in range(6)]
    f1 = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    b1 = [torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2)]
    out = Scatter(ray_o=v3[0], ray_d=v3[1], ray_tmax=f1[0], beta=v3[2],
                  alive=b1[0], prev_pdf=f1[1], prev_spec=b1[1],
                  shadow_o=v3[3], shadow_d=v3[4], shadow_tmax=f1[2],
                  pending=v3[5])
    if n:
        cuda.launch("path_scatter_lambert", *args, n, lt.n_lights,
                    lt.l_tri_p, lt.l_emit, lt.l_area, lt.l_tri_rev,
                    lt.l_twosided, *out)
    return out


# ---------------------------------------------------------------------------
# K23 path_nee_add
# ---------------------------------------------------------------------------

def path_nee_add_plain(L_in, pending, occluded):
    """Plain twin of K23: L plus ``pending`` where the shadow ray found no
    occluder (``occluded`` (B,) bool), plus 0 elsewhere."""
    return L_in + torch.where(occluded[:, None], 0.0, pending)


def path_nee_add(L_in, pending, occluded):
    """K23 (csrc/pathshade.cu): ``path_nee_add_plain``'s L. CPU tensors
    take the plain twin, CUDA tensors launch the kernel."""
    cuda.refuse_grad("K23 path_nee_add's gradient", (L_in, pending),
                     GRAD_ITEM)
    if not cuda.use_kernel(L_in):
        return path_nee_add_plain(L_in, pending, occluded)
    n, dev = L_in.shape[0], L_in.device
    args = [_lane(L_in, "L", torch.float32, (n, 3), dev),
            _lane(pending, "pending", torch.float32, (n, 3), dev),
            _lane(occluded, "occluded", torch.bool, (n,), dev)]
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        cuda.launch("path_nee_add", *args, n, out)
    return out


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

def _lane(t, name, dtype, shape, dev):
    """``t`` made contiguous, checked for the kernel (cuda.check)."""
    t = t.contiguous()
    cuda.check(t, name, dtype, shape, dev)
    return t


def _pmf_arg(pmf, n, dev):
    """-> (the (B,) pmf table or None, the pmf of every lane where there is
    no table)."""
    if pmf is None:
        return None, 0.0
    if isinstance(pmf, torch.Tensor):
        return _lane(pmf, "pmf", torch.float32, (n,), dev), 0.0
    return None, float(pmf)


def _check_lights(lt, dev):
    """The triangle light tables the kernels read (scene/lights.py)."""
    if not lt.kinds <= {"tri"}:
        raise ValueError(f"K21-K23 take triangle lights only, not "
                         f"{sorted(lt.kinds)}")
    k = lt.n_lights
    cuda.check(lt.l_tri_p, "l_tri_p", torch.float32, (k, 3, 3), dev)
    cuda.check(lt.l_emit, "l_emit", torch.float32, (k, 3), dev)
    cuda.check(lt.l_area, "l_area", torch.float32, (k,), dev)
    cuda.check(lt.l_tri_rev, "l_tri_rev", torch.bool, (k,), dev)
    cuda.check(lt.l_twosided, "l_twosided", torch.bool, (k,), dev)
