"""Port parity: the watertight ray-triangle test (the plain version of the
device function inside kernels K1 and K2) against the JAX package, on random
rays and on rays exactly through shared edges and vertices, where the
exact-residual fallback of the edge functions decides.

Tolerance: ``hit`` equal; t and the barycentrics within 1e-6 relative."""
import jax.numpy as jnp
import numpy as np
import torch

from rustracer_tpu.ops import triangle as jtri
from rustracer_tpu_torch.ops import triangle as tri

torch.set_num_threads(1)

RTOL = 1e-6


def _both(o, d, t_max, p0, p1, p2):
    ref = jtri.triangle_intersect(*(jnp.asarray(a)
                                    for a in (o, d, t_max, p0, p1, p2)))
    out = tri.triangle_intersect(*(torch.as_tensor(a)
                                   for a in (o, d, t_max, p0, p1, p2)))
    return ref, out


def _check(ref, out):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(out.hit.numpy(), hit)
    for f in ("t", "b0", "b1", "b2"):
        np.testing.assert_allclose(getattr(out, f).numpy()[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   rtol=RTOL, atol=1e-30)
    return hit


def test_random_rays():
    rs = np.random.default_rng(0)
    n = 8192
    p0 = rs.normal(0, 1, (n, 3)).astype(np.float32)
    p1 = (p0 + rs.normal(0, 0.5, (n, 3))).astype(np.float32)
    p2 = (p0 + rs.normal(0, 0.5, (n, 3))).astype(np.float32)
    b = rs.dirichlet([1, 1, 1], n).astype(np.float32)
    target = b[:, :1] * p0 + b[:, 1:2] * p1 + b[:, 2:] * p2
    o = (target + rs.normal(0, 3, (n, 3))).astype(np.float32)
    # half aim at a point of the triangle, half anywhere
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o,
                 rs.normal(0, 1, (n, 3))).astype(np.float32)
    t_max = rs.uniform(0.5, 10, n).astype(np.float32)
    hit = _check(*_both(o, d, t_max, p0, p1, p2))
    assert 0.2 < hit.mean() < 0.8


def test_shared_edges_and_vertices():
    """A quad split along its diagonal, hit exactly on the diagonal, the
    outer edges and the corners (coordinates exact in float32), along the
    axes, where edge functions round to exactly zero."""
    quad = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                    np.float32)
    tris = [(0, 1, 2), (0, 2, 3)]
    pts = np.array([[0, 0], [0.5, 0.5], [-0.25, -0.25], [1, 0], [0, 1],
                    [-1, 0], [0, -1], [1, 1], [-1, -1], [1, -1], [-1, 1],
                    [0.5, 0], [0, 0.5]], np.float32)
    rows = []
    for a, b, c in tris:
        for x, y in pts:
            for dz in (1.0, -1.0):
                rows.append((quad[a], quad[b], quad[c],
                             np.array([x, y, -2.0 * dz], np.float32),
                             np.array([0, 0, dz], np.float32)))
    p0, p1, p2, o, d = (np.stack(c) for c in zip(*rows))
    t_max = np.full(len(rows), 10.0, np.float32)
    hit = _check(*_both(o, d, t_max, p0, p1, p2))
    # watertightness: every interior point of the quad is hit by at least
    # one of the two triangles sharing the diagonal
    per_tri = hit.reshape(2, len(pts), 2)
    assert per_tri.any(axis=0)[:3].all()


def test_edge_fn_zero_fallback():
    """Products that round to equal values but differ exactly: the residual
    decides the sign, as in the reference."""
    rs = np.random.default_rng(1)
    a = rs.uniform(1, 2, 4096).astype(np.float32)
    b = rs.uniform(1, 2, 4096).astype(np.float32)
    eps = np.float32(2.0 ** -23)
    ax, by = a, b
    ay, bx = (a * (1 + eps)).astype(np.float32), (b * (1 - eps)).astype(np.float32)
    ref = np.asarray(jtri._edge_fn(*(jnp.asarray(v) for v in (ax, ay, bx, by))))
    out = tri._edge_fn(*(torch.as_tensor(v) for v in (ax, ay, bx, by))).numpy()
    np.testing.assert_array_equal(np.sign(out), np.sign(ref))
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
