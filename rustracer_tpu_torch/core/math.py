"""Vector math over (..., 3) float32 tensors (port of rustracer_tpu/core/math.py,
the subset the render path uses).

Sums over the size-3 axis are written out as ``(x + y) + z`` so that the
rounding order is fixed and the same in the plain version, in the JAX
reference and in the CUDA kernels.
"""
from __future__ import annotations

import numpy as np
import torch

MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps * 0.5)
INFINITY = float("inf")
PI = np.float32(np.pi)
INV_PI = float(np.float32(1.0 / np.pi))


def gamma(n) -> float:
    """Error-bound gamma(n) = n*eps / (1 - n*eps), rounded to float32."""
    return float(np.float32((n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length_squared(v):
    return dot(v, v)


def distance_squared(a, b):
    return length_squared(a - b)


def normalize(v, eps=1e-20):
    """Safe normalize: zero vectors stay finite."""
    n2 = length_squared(v)[..., None]
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v1):
    """Orthonormal frame (v2, v3) around the unit vector v1, v1 x v2 = v3."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = torch.rsqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_x[..., None],
                     torch.stack([-z * inv_a, zero, x * inv_a], dim=-1),
                     torch.stack([zero, z * inv_a, -y * inv_a], dim=-1))
    return v2, cross(v1, v2)


def quadratic(a, b, c):
    """Stable quadratic solve -> (t0 <= t1, has_solution): the reference's
    float32 form q = -0.5 (b +- sqrt(disc)), t1 = c / q, in its order."""
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / a
    t1 = c / torch.where(q == 0.0, 1.0, q)
    t1 = torch.where(q == 0.0, t0, t1)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), has


def next_float_up(x):
    """Next representable float32 toward +inf."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)     # -0 -> +0
    bits = x.view(torch.int32)
    out = torch.where(bits < 0, bits - 1, bits + 1).view(torch.float32)
    return torch.where(torch.isinf(x) & (x > 0), x, out)


def next_float_down(x):
    return -next_float_up(-x)


def offset_ray_origin(p, p_error, n, w):
    """Offset a spawned ray origin off the surface along the geometric
    normal by the projected error bound, rounded away from p."""
    d = (torch.abs(n[..., 0]) * p_error[..., 0]
         + torch.abs(n[..., 1]) * p_error[..., 1]
         + torch.abs(n[..., 2]) * p_error[..., 2])
    offset = d[..., None] * n
    offset = torch.where((dot(w, n) < 0.0)[..., None], -offset, offset)
    po = p + offset
    return torch.where(offset > 0.0, next_float_up(po),
                       torch.where(offset < 0.0, next_float_down(po), po))
