"""Watertight ray-triangle intersection and triangle helpers (port of
rustracer_tpu/ops/triangle.py).

``triangle_intersect_c`` is the plain version of the device function
``rt::tri_intersect`` (csrc/common.cuh) that kernels K1 and K2 call. Both
compute op for op the same float32 expressions; the kernels' exact residual
uses fmaf where this version, like the JAX package, splits with Dekker (see
``_two_prod``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import coordinate_system, cross, gamma, normalize
from ..core.sampling import uniform_sample_triangle

GAMMA2, GAMMA3, GAMMA5, GAMMA6, GAMMA7 = (gamma(n) for n in (2, 3, 5, 6, 7))


class TriHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def _two_prod(a, b):
    """Error-free product (p, err), a*b == p + err exactly, by Dekker/
    Veltkamp splitting (splitter 2^12 + 1 for the 24-bit mantissa). It
    overflows for |a|, |b| above ~2^103, where the caller zeroes err."""
    ca = a * 4097.0
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = b * 4097.0
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _edge_fn(ax, ay, bx, by):
    """ax*by - ay*bx; where the float result is exactly 0 its sign comes
    from the exact residual of the two products (p1 - p2 is then exact)."""
    p1, e1 = _two_prod(ax, by)
    p2, e2 = _two_prod(ay, bx)
    d = p1 - p2
    exact = e1 - e2
    exact = torch.where(torch.isfinite(exact), exact, torch.zeros_like(exact))
    return torch.where(d == 0.0, exact, d)


def _unpack(v):
    return v[..., 0], v[..., 1], v[..., 2]


def triangle_intersect(o, d, t_max, p0, p1, p2) -> TriHit:
    """Watertight intersect of (..., 3) rays with (..., 3) triangles."""
    return triangle_intersect_c(_unpack(o), _unpack(d), t_max, _unpack(p0),
                                _unpack(p1), _unpack(p2))


def triangle_intersect_c(oc, dc, t_max, p0c, p1c, p2c) -> TriHit:
    """Component-triple form; every argument broadcasts."""
    ox, oy, oz = oc
    dcx, dcy, dcz = dc
    adx, ady, adz = torch.abs(dcx), torch.abs(dcy), torch.abs(dcz)
    is0 = (adx >= ady) & (adx >= adz)
    is1 = ~is0 & (ady >= adz)

    def permute(cx, cy, cz):
        # kz=0 -> (y,z,x); kz=1 -> (z,x,y); kz=2 -> (x,y,z)
        return (torch.where(is0, cy, torch.where(is1, cz, cx)),
                torch.where(is0, cz, torch.where(is1, cx, cy)),
                torch.where(is0, cx, torch.where(is1, cy, cz)))

    dx, dy, dz = permute(dcx, dcy, dcz)
    sz = 1.0 / dz
    sx = -dx * sz
    sy = -dy * sz

    def shear(pc):
        ptx, pty, ptz = permute(pc[0] - ox, pc[1] - oy, pc[2] - oz)
        return ptx + sx * ptz, pty + sy * ptz, ptz * sz

    x0, y0, z0 = shear(p0c)
    x1, y1, z1 = shear(p1c)
    x2, y2, z2 = shear(p2c)
    e0 = _edge_fn(x1, y1, x2, y2)
    e1 = _edge_fn(x2, y2, x0, y0)
    e2 = _edge_fn(x0, y0, x1, y1)

    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nonzero = det != 0.0
    inv_det = 1.0 / torch.where(nonzero, det, torch.ones_like(det))
    t = (e0 * z0 + e1 * z1 + e2 * z2) * inv_det
    # conservative error bound on t (PBRT 3.9.6)
    amax = lambda a, b, c: torch.maximum(torch.maximum(torch.abs(a),  # noqa: E731
                                                       torch.abs(b)),
                                         torch.abs(c))
    max_zt, max_xt, max_yt = amax(z0, z1, z2), amax(x0, x1, x2), amax(y0, y1, y2)
    max_e = amax(e0, e1, e2)
    delta_z = GAMMA3 * max_zt
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt
                     + delta_x * max_yt)
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * torch.abs(inv_det)
    hit = same_sign & nonzero & (t > delta_t) & (t < t_max)
    return TriHit(hit=hit, t=t, b0=e0 * inv_det, b1=e1 * inv_det,
                  b2=e2 * inv_det)


def _bary(b0, b1, b2, a, b, c):
    return b0[..., None] * a + b1[..., None] * b + b2[..., None] * c


def triangle_point_error(b0, b1, b2, p0, p1, p2):
    """Point at the barycentrics and its gamma(7)-scaled error bound."""
    abs_sum = (torch.abs(b0[..., None] * p0) + torch.abs(b1[..., None] * p1)
               + torch.abs(b2[..., None] * p2))
    return _bary(b0, b1, b2, p0, p1, p2), GAMMA7 * abs_sum


def triangle_sample(u, p0, p1, p2):
    """Uniform area sample -> (p, unit normal following the winding, error)."""
    b = uniform_sample_triangle(u)
    b0 = b[..., 0]
    b1 = b[..., 1]
    b2 = 1.0 - b0 - b1
    p = _bary(b0, b1, b2, p0, p1, p2)
    ng = normalize(cross(p1 - p0, p2 - p0))
    abs_sum = (torch.abs(b0[..., None] * p0) + torch.abs(b1[..., None] * p1)
               + torch.abs(b2[..., None] * p2))
    return p, ng, GAMMA6 * abs_sum


def _uv_solve(uv0, uv1, uv2, a0, a1, a2):
    """2x2 uv solve of the derivative of a vertex attribute: -> (d/du, d/dv,
    degenerate)."""
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    da02 = a0 - a2
    da12 = a1 - a2
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degenerate = torch.abs(det) < 1e-12
    inv = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    ddu = (duv12[..., 1, None] * da02 - duv02[..., 1, None] * da12) \
        * inv[..., None]
    ddv = (-duv12[..., 0, None] * da02 + duv02[..., 0, None] * da12) \
        * inv[..., None]
    return ddu, ddv, degenerate


def triangle_partial_derivs(p0, p1, p2, uv0, uv1, uv2):
    """dpdu/dpdv from the uv parameterization; a frame around the geometric
    normal when the parameterization is degenerate."""
    dpdu, dpdv, degenerate = _uv_solve(uv0, uv1, uv2, p0, p1, p2)
    fb_u, fb_v = coordinate_system(normalize(cross(p2 - p0, p1 - p0)))
    return (torch.where(degenerate[..., None], fb_u, dpdu),
            torch.where(degenerate[..., None], fb_v, dpdv))


def triangle_normal_derivs(n0, n1, n2, uv0, uv1, uv2):
    """Shading-normal derivatives dndu/dndv; zero when degenerate."""
    dndu, dndv, degenerate = _uv_solve(uv0, uv1, uv2, n0, n1, n2)
    z = torch.zeros_like(dndu)
    return (torch.where(degenerate[..., None], z, dndu),
            torch.where(degenerate[..., None], z, dndv))
