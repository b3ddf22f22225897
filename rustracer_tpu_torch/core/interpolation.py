"""Catmull-Rom splines and Fourier series, batched over lanes (port of
rustracer_tpu/core/interpolation.py).

Every routine takes lanes along the leading axis. The reference's
iterate-until-converged Newton-bisection loops are loops of a fixed trip
count (``NEWTON_ITERS``, and ceil(log2 N) + 1 bisection steps): lanes
that have converged keep refining, as there. The cosine series is a dense
(..., M) evaluation of cos(k phi), as there.

Python floats meet float32 tensors rounded to float32, as JAX's weak typing
rounds them. A table ``values`` or ``cdf`` of ``sample_catmull_rom_2d`` is
one (N1, N2) table or a stack (T, N1, N2) indexed by per-lane ``rows``
(the reference takes per-lane (..., N1, N2) tables: ``tab[rows]``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
INV_2_PI = 1.0 / (2.0 * math.pi)
NEWTON_ITERS = 30


def find_interval(nodes, x):
    """Largest i with nodes[..., i] <= x, clamped to [0, N - 2]; ``nodes``
    (N,) shared or (..., N) per lane."""
    n = nodes.shape[-1]
    le = (nodes <= x[..., None]).sum(-1, dtype=torch.int32)
    return torch.clamp(le - 1, 0, n - 2)


def node_at(nodes, i):
    """nodes[..., i] for shared (N,) or per-lane (..., N) nodes."""
    if nodes.dim() == 1:
        return nodes[i.long()]
    return torch.gather(nodes, -1, i.long()[..., None])[..., 0]


def catmull_rom_weights(nodes, x):
    """-> (offset (...,) int32, weights (..., 4), valid (...,)): the spline
    weights of x against ``nodes``; lanes outside the nodes get valid False
    and zero weights."""
    n = nodes.shape[-1]
    valid = (x >= nodes[..., 0]) & (x <= nodes[..., -1])
    idx = find_interval(nodes, x)
    x0 = node_at(nodes, idx)
    x1 = node_at(nodes, idx + 1)
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-20)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    xm1 = node_at(nodes, torch.clamp(idx - 1, min=0))
    w0_in = (t3 - 2.0 * t2 + t) * (x1 - x0) / torch.clamp(x1 - xm1, min=1e-20)
    w0_edge = t3 - 2.0 * t2 + t
    has_prev = idx > 0
    w0 = torch.where(has_prev, -w0_in, 0.0)
    w1 = torch.where(has_prev, w1, w1 - w0_edge)
    w2 = w2 + torch.where(has_prev, w0_in, w0_edge)
    xp2 = node_at(nodes, torch.clamp(idx + 2, max=n - 1))
    w3_in = (t3 - t2) * (x1 - x0) / torch.clamp(xp2 - x0, min=1e-20)
    w3_edge = t3 - t2
    has_next = idx + 2 < n
    w1 = w1 - torch.where(has_next, w3_in, w3_edge)
    w2 = w2 + torch.where(has_next, 0.0, w3_edge)
    w3 = torch.where(has_next, w3_in, 0.0)
    w = torch.stack([w0, w1, w2, w3], -1)
    return (idx - 1).int(), torch.where(valid[..., None], w, 0.0), valid


def integrate_catmull_rom_np(x, values):
    """Host-side CDF of a spline (numpy): values (..., N) -> (cdf (..., N),
    total (...,))."""
    x = np.asarray(x, np.float32)
    v = np.asarray(values, np.float32)
    cdf = np.zeros(v.shape, np.float32)
    f0 = v[..., :-1]
    f1 = v[..., 1:]
    width = x[1:] - x[:-1]
    d0 = np.empty_like(f0)
    d0[..., 1:] = width[1:] * (f1[..., 1:] - v[..., :-2]) / (x[2:] - x[:-2])
    d0[..., 0] = f1[..., 0] - f0[..., 0]
    d1 = np.empty_like(f0)
    d1[..., :-1] = width[:-1] * (v[..., 2:] - f0[..., :-1]) / (x[2:] - x[:-2])
    d1[..., -1] = f1[..., -1] - f0[..., -1]
    seg = ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
    cdf[..., 1:] = np.cumsum(seg, axis=-1)
    return cdf, cdf[..., -1]


def segment_derivs(f_m1, f0, f1, f2, x_m1, x0, x1, x2, has_prev, has_next):
    """The spline's derivatives at the ends of a segment."""
    width = x1 - x0
    d0 = torch.where(has_prev,
                     width * (f1 - f_m1) / torch.clamp(x1 - x_m1, min=1e-20),
                     f1 - f0)
    d1 = torch.where(has_next,
                     width * (f2 - f0) / torch.clamp(x2 - x0, min=1e-20),
                     f1 - f0)
    return d0, d1


_THIRD = float(np.float32(1.0 / 3.0))


def _spline_int(t, f0, f1, d0, d1):
    return t * (f0 + t * (0.5 * d0 + t * (
        _THIRD * (-2.0 * d0 - d1) + f1 - f0
        + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))


def _spline_val(t, f0, f1, d0, d1):
    return f0 + t * (d0 + t * (-2.0 * d0 - d1 + 3.0 * (f1 - f0)
                               + t * (d0 + d1 + 2.0 * (f0 - f1))))


def invert_spline_segment(f0, f1, d0, d1, u):
    """Newton-bisection for t in [0, 1] with the segment's integral equal to
    u, NEWTON_ITERS steps. -> (t, the spline at t)."""
    lin = torch.abs(f0 - f1) > 1e-12
    t = torch.where(
        lin, (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * u * (f1 - f0),
                                          min=0.0)))
        / torch.where(lin, f0 - f1, 1.0),
        u / torch.clamp(f0, min=1e-20))
    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    for _ in range(NEWTON_ITERS):
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        big_f = _spline_int(t, f0, f1, d0, d1)
        f = _spline_val(t, f0, f1, d0, d1)
        lo = big_f - u < 0.0
        a = torch.where(lo, t, a)
        b = torch.where(lo, b, t)
        t = t - (big_f - u) / torch.where(torch.abs(f) > 1e-20, f, 1.0)
    t = torch.minimum(torch.maximum(t, a), b)
    return t, _spline_val(t, f0, f1, d0, d1)


def invert_catmull_rom(x, values, u):
    """x where the spline through (x (N,), monotone values (N,)) equals u
    (...,), NEWTON_ITERS Newton-bisection steps."""
    n = x.shape[0]
    below = u <= values[0]
    above = u >= values[-1]
    i = find_interval(values, u).long()
    x0, x1 = x[i], x[i + 1]
    f0, f1 = values[i], values[i + 1]
    im1 = torch.clamp(i - 1, min=0)
    ip2 = torch.clamp(i + 2, max=n - 1)
    d0, d1 = segment_derivs(values[im1], f0, f1, values[ip2], x[im1], x0, x1,
                            x[ip2], i > 0, i + 2 < n)
    t = torch.full_like(u, 0.5)
    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    for _ in range(NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        t2 = t * t
        t3 = t2 * t
        big_f = ((2.0 * t3 - 3.0 * t2 + 1.0) * f0
                 + (-2.0 * t3 + 3.0 * t2) * f1
                 + (t3 - 2.0 * t2 + t) * d0 + (t3 - t2) * d1)
        f = ((6.0 * t2 - 6.0 * t) * f0 + (-6.0 * t2 + 6.0 * t) * f1
             + (3.0 * t2 - 4.0 * t + 1.0) * d0 + (3.0 * t2 - 2.0 * t) * d1)
        lo = big_f - u < 0.0
        a = torch.where(lo, t, a)
        b = torch.where(lo, b, t)
        t = t - (big_f - u) / torch.where(torch.abs(f) > 1e-20, f, 1.0)
    t = torch.minimum(torch.maximum(t, a), b)
    out = x0 + t * (x1 - x0)
    return torch.where(below, x[0], torch.where(above, x[-1], out))


def fourier(ak, cos_phi):
    """sum_k ak[..., k] cos(k phi) with phi = acos(cos_phi); ak (..., M)
    zero-padded."""
    m = ak.shape[-1]
    phi = torch.arccos(torch.clamp(cos_phi, -1.0, 1.0))
    k = torch.arange(m, dtype=torch.float32, device=ak.device)
    return (ak * torch.cos(phi[..., None] * k)).sum(-1)


_PI32 = float(np.float32(PI))
_2PI32 = float(np.float32(2.0 * PI))
_INV_2PI32 = float(np.float32(INV_2_PI))


def sample_fourier(ak, u):
    """phi with the series' integral from 0 equal to u times its total, by
    NEWTON_ITERS Newton-bisection steps on a half turn, mirrored for
    u >= 0.5. ak (..., M) zero-padded, u (...,) in [0, 1). -> (the series
    at phi, its pdf, phi)."""
    m = ak.shape[-1]
    flip = u >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    a0 = ak[..., 0]
    k = torch.arange(m, dtype=torch.float32, device=ak.device)
    k_recip = torch.where(k > 0, 1.0 / torch.clamp(k, min=1.0), 0.0)

    def eval_ff(phi):
        kphi = phi[..., None] * k
        big_f = a0 * phi + (ak * k_recip * torch.sin(kphi)).sum(-1)
        f = (ak * torch.cos(kphi)).sum(-1)
        return big_f - u * a0 * _PI32, f

    phi = torch.full_like(u, float(np.float32(0.5 * PI)))
    a = torch.zeros_like(u)
    b = torch.full_like(u, _PI32)
    for _ in range(NEWTON_ITERS):
        big_f, f = eval_ff(phi)
        hi = big_f > 0.0
        b = torch.where(hi, phi, b)
        a = torch.where(hi, a, phi)
        phi = phi - big_f / torch.where(torch.abs(f) > 1e-20, f, 1.0)
        phi = torch.where((phi > a) & (phi < b), phi, 0.5 * (a + b))
    _, f = eval_ff(phi)
    phi = torch.where(flip, _2PI32 - phi, phi)
    pdf = _INV_2PI32 * f / torch.clamp(a0, min=1e-20)
    return f, torch.where(a0 > 0, pdf, 0.0), phi


def _table_at(tab, rows, row, col):
    if rows is None:
        return tab[row.long(), col.long()]
    return tab[rows.long(), row.long(), col.long()]


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u, rows=None):
    """Sample x from the 2D spline ``values`` conditioned on ``alpha``:
    the cdf interpolated at alpha, inverted by bisection over its columns
    and a Newton-bisection inside the segment. nodes1, nodes2 (N,) or
    (..., N) per lane; values, cdf (N1, N2), or (T, N1, N2) with ``rows``
    (...,) picking each lane's table. -> (x, the spline at x, pdf); lanes
    with alpha outside nodes1 or a zero total get zeros."""
    n1, n2 = values.shape[-2], values.shape[-1]
    off, w, valid = catmull_rom_weights(nodes1, alpha)

    def interp(tab, idx):
        out = torch.zeros_like(alpha)
        for i in range(4):
            row = torch.clamp(off + i, 0, n1 - 1)
            out = out + w[..., i] * _table_at(tab, rows, row, idx)
        return out

    maximum = interp(cdf, torch.full_like(off, n2 - 1))
    u = u * maximum
    lo = torch.zeros_like(off)
    hi = torch.full_like(off, n2 - 1)
    for _ in range(int(np.ceil(np.log2(max(2, n2)))) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        le = interp(cdf, mid) <= u
        lo = torch.where(le, mid, lo)
        hi = torch.where(le, hi, mid)
    idx = torch.clamp(lo, 0, n2 - 2)
    f0 = interp(values, idx)
    f1 = interp(values, idx + 1)
    x0 = node_at(nodes2, idx)
    x1 = node_at(nodes2, idx + 1)
    width = x1 - x0
    u_seg = (u - interp(cdf, idx)) / torch.clamp(width, min=1e-20)
    im1 = torch.clamp(idx - 1, min=0)
    ip2 = torch.clamp(idx + 2, max=n2 - 1)
    d0, d1 = segment_derivs(interp(values, im1), f0, f1, interp(values, ip2),
                            node_at(nodes2, im1), x0, x1, node_at(nodes2, ip2),
                            idx > 0, idx + 2 < n2)
    t, fhat = invert_spline_segment(f0, f1, d0, d1, u_seg)
    x = x0 + width * t
    pdf = fhat / torch.clamp(maximum, min=1e-20)
    bad = ~valid | (maximum <= 0)
    return (torch.where(bad, 0.0, x), torch.where(bad, 0.0, fhat),
            torch.where(bad, 0.0, pdf))
