"""Perlin noise, fbm and turbulence (port of rustracer_tpu/core/noise.py)
and their hand kernel K18 (csrc/noise.cu).

The reference's lattice is a hash (core/rng.py ``hash_u32`` of the cell's
integer corner) instead of PBRT's permutation table, its fade is the
quintic ``_smooth``, and its partial octave is taken after the full loop at
``lam = 1.99**max_octaves`` and ``o = omega**max_octaves`` (PBRT takes it
at octave ``n_int``). The port reproduces all three. ``lam`` and ``o``
are Python floats accumulated in double, as there; each is rounded to
float32 where it meets a tensor, as JAX's weak typing rounds it.

``fbm`` and ``turbulence`` route by device: CPU tensors take the plain
versions (``fbm_plain``, ``turbulence_plain``), CUDA tensors launch K18,
one thread a lane with the octave loop in registers.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from .rng import MASK32, hash_u32


def _f32(x: float) -> float:
    return float(np.float32(x))


def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _smooth(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(t, a, b):
    return a + t * (b - a)


def noise3(p):
    """Perlin noise at p (B, 3) -> (B,) in about [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    corner = pi.to(torch.int32).to(torch.int64) & MASK32
    ix, iy, iz = corner[:, 0], corner[:, 1], corner[:, 2]
    x, y, z = pf[:, 0], pf[:, 1], pf[:, 2]
    u, v, w = _smooth(x), _smooth(y), _smooth(z)

    def g(dx, dy, dz):
        h = hash_u32((ix + dx) & MASK32, (iy + dy) & MASK32,
                     (iz + dz) & MASK32)
        return _grad(h, x - dx, y - dy, z - dz)

    x00 = _lerp(u, g(0, 0, 0), g(1, 0, 0))
    x10 = _lerp(u, g(0, 1, 0), g(1, 1, 0))
    x01 = _lerp(u, g(0, 0, 1), g(1, 0, 1))
    x11 = _lerp(u, g(0, 1, 1), g(1, 1, 1))
    return _lerp(w, _lerp(v, x00, x10), _lerp(v, x01, x11))


def octaves(dpdx, dpdy, max_octaves: int):
    """-> (n, floor(n)) (B,): the octave count from the footprint,
    -1 - log2(max(|dpdx|^2, |dpdy|^2)) / 2 clipped to [0, max_octaves]."""
    len2 = torch.maximum((dpdx * dpdx).sum(-1), (dpdy * dpdy).sum(-1))
    n = torch.clamp(-1.0 - 0.5 * torch.log2(torch.clamp(len2, min=1e-24)),
                    0.0, float(max_octaves))
    return n, torch.floor(n)


def _sum_octaves(p, dpdx, dpdy, omega, max_octaves, absolute):
    n, n_int = octaves(dpdx, dpdy, max_octaves)
    out = torch.zeros_like(p[:, 0])
    lam = o = 1.0
    for i in range(max_octaves):
        v = noise3(p * _f32(lam))
        v = _f32(o) * (torch.abs(v) if absolute else v)
        out = out + torch.where(i < n_int, v, 0.0)
        lam *= 1.99
        o *= omega
    v = _smooth(n - n_int) * noise3(p * _f32(lam))
    return out + _f32(o) * (torch.abs(v) if absolute else v)


def fbm_plain(p, dpdx, dpdy, omega: float, max_octaves: int):
    """Plain version of K18's fbm: the octave sum of noise3 at p * 1.99^i
    weighted omega^i, the partial octave last."""
    return _sum_octaves(p, dpdx, dpdy, omega, max_octaves, False)


def turbulence_plain(p, dpdx, dpdy, omega: float, max_octaves: int):
    """Plain version of K18's turbulence: fbm of |noise3|."""
    return _sum_octaves(p, dpdx, dpdy, omega, max_octaves, True)


def _k18(p, dpdx, dpdy, omega, max_octaves, turbulence):
    n = p.shape[0]
    dev = p.device
    args = [t.contiguous() for t in (p, dpdx, dpdy)]
    for name, t in zip(("p", "dpdx", "dpdy"), args):
        cuda.check(t, name, torch.float32, (n, 3), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        cuda.launch("noise_fbm", *args, n, float(omega), int(max_octaves),
                    int(turbulence), out)
    return out


def fbm(p, dpdx, dpdy, omega: float, max_octaves: int):
    """Fractional Brownian motion at p (B, 3), its octaves clamped by the
    footprint dpdx, dpdy (B, 3) -> (B,) float32. CPU tensors take the plain
    version, CUDA tensors launch K18."""
    if not cuda.use_kernel(p):
        return fbm_plain(p, dpdx, dpdy, omega, max_octaves)
    return _k18(p, dpdx, dpdy, omega, max_octaves, False)


def turbulence(p, dpdx, dpdy, omega: float, max_octaves: int):
    """Absolute-value fbm at p (B, 3) -> (B,) float32. CPU tensors take the
    plain version, CUDA tensors launch K18."""
    if not cuda.use_kernel(p):
        return turbulence_plain(p, dpdx, dpdy, omega, max_octaves)
    return _k18(p, dpdx, dpdy, omega, max_octaves, True)
