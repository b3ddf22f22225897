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
TWO_PI = float(np.float32(2.0) * PI)


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


def spherical_theta(v):
    """Polar angle of unit vectors v (..., 3)."""
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    """Azimuth of v (..., 3) in [0, 2 pi)."""
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + TWO_PI, p)


def find_interval(cdf, x):
    """The largest i with cdf[..., i] <= x, clipped to [0, N - 2]: the
    reference's count sum(cdf <= x) - 1 over the row, integer for integer
    (on a non-decreasing cdf the same number as a bisection's). cdf (N,)
    or (..., N) row per x; x (...) -> int64."""
    n = cdf.shape[-1]
    idx = (cdf <= x[..., None]).sum(-1) - 1
    return torch.clamp(idx, 0, n - 2)


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


# --- shading-space trigonometry: z is the shading normal, w a unit
# direction in that frame ---

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    zero = st == 0.0
    return torch.where(zero, 1.0, torch.clamp(
        w[..., 0] / torch.where(zero, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    zero = st == 0.0
    return torch.where(zero, 0.0, torch.clamp(
        w[..., 1] / torch.where(zero, 1.0, st), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def reflect(wo, n):
    """Mirror wo about n (both pointing away from the surface)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta -> (wt, valid); valid is
    False on total internal reflection."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0)
    sin2_theta_t = eta * eta * sin2_theta_i
    valid = sin2_theta_t < 1.0
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin2_theta_t, min=0.0))
    wt = eta[..., None] * (-wi) \
        + (eta * cos_theta_i - cos_theta_t)[..., None] * n
    return wt, valid


def erf_inv(x):
    """Inverse error function: PBRT's single-precision polynomial (the
    reference's, not torch.erfinv)."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))
    small = w < 5.0
    w_s = w - 2.5
    w_l = torch.sqrt(torch.clamp(w, min=5.0)) - 3.0
    p_s = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941):
        p_s = c + p_s * w_s
    p_l = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p_l = c + p_l * w_l
    return torch.where(small, p_s, p_l) * x


def erf(x):
    return torch.erf(x)
