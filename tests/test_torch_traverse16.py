"""Port parity: the wide-BVH walk (plain version of kernel K1) against the
JAX package's ``bvh16_intersect_counts``, closest hit and any hit, on the
random triangle soups of tests/test_bvh16.py, the small matte dragon and a
chain-shaped table 20 levels deep.

Tolerance: hit and prim equal except where two candidate hits agree in t
within 1e-5 relative (counted, at most 0.1% of the rays); t within 1e-5
relative, or 1e-6 absolute for short hits: compiled under jit, XLA contracts
the shear's multiply-adds into FMAs, so the reference itself rounds the
sheared z differently from its eager form by about one ulp of the scene
scale (about 1), and that floor dominates t's relative error below t ~ 0.1;
the observed counts [rows read, triangle tests] equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.accel.traverse16 import bvh16_intersect_counts
from rustracer_tpu.accel.wide import build_wide_arrays as jax_build_wide
from rustracer_tpu.core.ray import make_ray
from rustracer_tpu.scene.tables import make_geometry as jax_make_geometry
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.accel.traverse16 import traverse16
from rustracer_tpu_torch.scenes import dragon_tris

from test_bvh import random_rays, random_soup
from test_torch_cuda import chain_rays, chain_tables

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6


def _near_tie(geom, o, d, t, prim_a, prim_b):
    """Rays whose two reported triangles are hit at t within RTOL."""
    from rustracer_tpu_torch.ops.triangle import triangle_intersect
    rows = geom.t_shade
    tb = []
    for prim in (prim_a, prim_b):
        rec = rows[torch.as_tensor(prim).long()]
        th = triangle_intersect(torch.as_tensor(o), torch.as_tensor(d),
                                torch.full((len(o),), np.inf), rec[:, 0:3],
                                rec[:, 3:6], rec[:, 6:9])
        tb.append(th.t.numpy())
    return np.abs(tb[0] - tb[1]) <= RTOL * np.abs(t)


def _compare(jgeom, o, d, t_max, any_hit):
    geom = convert.geometry_from_jax(jgeom, device="cpu")
    ray = make_ray(jnp.asarray(o), jnp.asarray(d))._replace(
        t_max=jnp.asarray(t_max))
    jh, jt, jp, _, jc = (np.asarray(x) for x in
                         bvh16_intersect_counts(jgeom, ray, any_hit=any_hit))
    h, t, p, c = (x.numpy() for x in traverse16(
        geom, torch.tensor(o), torch.tensor(d), torch.tensor(t_max),
        any_hit=any_hit, with_counts=True))
    np.testing.assert_array_equal(c, jc.astype(np.int64))
    if any_hit:
        np.testing.assert_array_equal(h, jh)
        return h
    diff = (h != jh) | (p != jp)
    if diff.any():
        both = h & jh
        tie = both & _near_tie(geom, o, d, jt, p, jp)
        assert (diff & ~tie).sum() == 0, \
            f"{(diff & ~tie).sum()} rays differ without a near tie"
        assert diff.sum() <= 1e-3 * len(h)
    print(f"rays differing at near ties: {int(diff.sum())} of {len(h)}")
    both = h & jh
    np.testing.assert_allclose(t[both], jt[both], rtol=RTOL, atol=ATOL)
    assert np.all(np.isinf(t[~h])) and np.all(p[~h] == 0)
    return h


def _soup_case(n_tris, seed):
    tris = random_soup(n_tris, seed=seed)
    jgeom = jax_make_geometry(tris=tris, bvh=jax_build_wide(tris))
    rays = random_rays(2048, seed=seed + 1)
    o, d = np.asarray(rays.o), np.asarray(rays.d)
    t_max = np.random.default_rng(seed).uniform(0.5, 12.0, 2048)
    t_max = np.where(np.arange(2048) % 7 == 0, 0.0,   # dead lanes
                     np.where(np.arange(2048) % 3 == 0, np.inf, t_max))
    return jgeom, o, d, t_max.astype(np.float32)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris", [3, 17, 400])
def test_soups(n_tris, any_hit):
    h = _compare(*_soup_case(n_tris, 11 + n_tris), any_hit)
    if n_tris == 400:
        assert h.any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_small_dragon(any_hit):
    tris, _ = dragon_tris(4)
    jgeom = jax_make_geometry(tris=tris, bvh=jax_build_wide(tris))
    rs = np.random.default_rng(3)
    n = 4096
    # camera-like rays toward the mesh, and rays from points in and around
    # it in random directions (bounce-like, some hits very close)
    o = np.where(np.arange(n)[:, None] < n // 2,
                 np.array([0.0, 1.1, -3.4]),
                 rs.normal(0, 1, (n, 3)) * 0.6).astype(np.float32)
    target = rs.uniform(-1.2, 1.2, (n, 3))
    d = np.where(np.arange(n)[:, None] < n // 2, target - o,
                 rs.normal(0, 1, (n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, np.inf, np.float32)
    h = _compare(jgeom, o, d, t_max, any_hit)
    assert h.mean() > 0.3


@pytest.mark.parametrize("any_hit", [False, True])
def test_deep_chain(any_hit):
    """The same table in both walks (the JAX package takes the port's
    arrays), deeper than 16 levels: the stacks hold up to 19 entries."""
    tris, bvh = chain_tables()
    assert 16 < bvh["bvh16_depth"] <= 32
    jgeom = jax_make_geometry(tris=dict(tris), bvh=dict(bvh))
    h = _compare(jgeom, *chain_rays(), any_hit)
    assert h.mean() > 0.3
