"""The hand kernels of the port against their plain PyTorch versions, on a
CUDA device (the kernels have no CPU mode). Every test here skips without a
card. On the GPU machine, where JAX is absent, run them without the JAX
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: sampler bit-equal; traversal (K1) hit, prim, t bits and the
counts [rows read, triangle tests] equal (the same walk, the same float
operations in the same order), on camera rays, random soups, the small
dragon and a table deeper than 16 levels; interaction fields within
1e-5 absolute or relative (rsqrt rounds differently); film within 1e-5
relative (atomic adds in no fixed order), bit for bit on the render's box
0.5 splat (at most two taps a pixel); atlas EWA within 1e-5 absolute on
at least 99.9% of the lanes and zero where reg < 0 (the plain version divides by the weight sum
as a multiply by its reciprocal on the card, the kernel divides; a lane
whose mip level sits on an integer may floor to the other level); the
alive-first order, the slab moves and the row gather bit-equal; small
renders within the golden-image tolerance of tests/test_golden.py (mean
2e-3, p99 2e-2). The gradient path: K9 (a gather) and K7 as its own
transpose bit-equal; K10 and K11 (atomic sums) each sum within 1e-4 of the
sum of its terms' magnitudes; a train step's gradients within the bound of
the CPU parity test (tests/test_torch_grad.py). The scene front end: K4
and K9 with the triangle, Gaussian and Mitchell filters and K12 (the light
grid's contribution sums) within 1e-5 relative (the plain versions' exp,
sqrt and divides by a number round differently on the card; K12 takes an
approximate reciprocal square root; K4's warp sums add in another
order), K13 (the light pick and pmf lookup) bit-equal, the parsed Cornell
box's render within the golden-image tolerance of the all-plain
render. The quadrics: K14's closest and any hit bit-equal in hit and
quadric id, t within 1e-6 relative (the same float operations; atan2f
is the one call that may round apart from torch.atan2 on the card), K2's
quadric lanes as its triangle lanes (1e-5 absolute or relative: acosf,
sinf, atan2f and the normalisations), the parsed testball-matte's render
within the golden-image tolerance of the all-plain render, and those of
the glass, roughglass, plastic and textured testballs (rays leaving a
ball from inside, 32-float material rows, K5 on a sphere) likewise. The
lights: K15 (an infinite light's sample) with its radiance bit for bit
(which pins its integer searches) and the rest within 1e-5 relative
(sinf, cosf); K16 (the escaped rays' sky) within 1e-5 relative plus
1e-5 / sin theta near a pole, off the texel edges of the map's pdf; K12's
lights kernel within 1e-5 relative like its triangle kernel; the
veach-mis and envmap-dof renders within the golden-image tolerance of the
all-plain render. The rest of shading: K17 (the per-texture lookups, each
mode, flat and quad texel rows, each wrap) within 1e-5 absolute (the exact
mode 2e-5: expf near the ellipse's edge), K18 (fbm, turbulence) within
1e-5 absolute, K19's f and pdf within 1e-5 of the largest magnitude plus
1e-6 and its sampled direction within 1e-4, each on all but 1e-4 of the
lanes (a mip level, an octave count or a bisection step flipped by a
last-bit difference); the three scenes of tools/texture_work.py within
the golden-image tolerance of the all-plain render. K20 (K17's texel
gradient) within 1e-5 of the largest sum of its terms' magnitudes
(atomic adds in another order). The run surface: K3r (the random
sampler) bit for bit; K4d (the deterministic splat) bit for bit with its
plain version (the Gaussian within 1e-5 relative) and with itself on a
second run. The path chain: K21-K23 bit for bit with their plain twins on
every call of recorded steps (rsqrtf, cosf and sinf are the functions
torch calls on the card), and route renders within the golden-image
tolerance of the all-plain render."""
import contextlib
import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from rustracer_tpu_torch import cuda as K
from rustracer_tpu_torch.accel import bvh_build
from rustracer_tpu_torch.accel.traverse16 import MAX_DEPTH, traverse16
from rustracer_tpu_torch.core.interaction import compute_differentials
from rustracer_tpu_torch.integrators import path as P
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.ops.gather import row_gather
from rustracer_tpu_torch.ops.mipmap import (WRAP_BLACK, WRAP_CLAMP,
                                            WRAP_REPEAT, build_pyramid)
from rustracer_tpu_torch.render.film import Film, FilmState
from rustracer_tpu_torch.render.filters import Filter
from rustracer_tpu_torch.render.renderer import Lanes, RenderConfig, Renderer
from rustracer_tpu_torch.render.sampler import DimAllocator, SamplerConfig
from rustracer_tpu_torch.scene import atlas as A
from rustracer_tpu_torch.scene.tables import (build_interaction, make_geometry,
                                             scene_intersect)
from rustracer_tpu_torch.scenes import (build_dragon, build_dragon_matte,
                                        dragon_geometry)

pytestmark = pytest.mark.cuda

MATTE_KERNELS = ("sample_1d", "sample_2d", "traverse16_closest",
                 "traverse16_any", "build_interaction", "film_add_samples",
                 "row_gather")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def geometry(dev):
    return dragon_geometry(sub=4, device=dev)


@pytest.fixture(scope="module")
def scene(dev, geometry):
    ctx, cam, film, sampler, integ, _ = build_dragon_matte(
        sub=4, res=(64, 64), spp=2, device=dev, geometry=geometry)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=4096),
                 device=dev)
    px, py, v = r.tiles[0]
    pix = py.long() * 64 + px.long()
    smp = torch.full_like(pix, 1)
    p_film = torch.stack([px, py], -1).float() + sampler.get_2d(pix, smp, 0)
    ray = cam.generate_ray_differential(p_film)
    return dict(ctx=ctx, film=film, sampler=sampler, renderer=r, pix=pix,
                smp=smp, p_film=p_film, ray=ray, valid=v)


@pytest.fixture(scope="module")
def textured(dev, geometry):
    """The textured dragon (64-spp config) at 64^2 and the camera hits of
    its one tile, with their texture differentials."""
    ctx, cam, film, sampler, integ, _ = build_dragon(
        sub=4, res=(64, 64), device=dev, geometry=geometry)
    px, py = torch.meshgrid(torch.arange(64, device=dev),
                            torch.arange(64, device=dev), indexing="xy")
    p_film = torch.stack([px.ravel(), py.ravel()], -1).float() + 0.5
    ray = cam.generate_ray_differential(p_film).scaled_differentials(
        1.0 / np.sqrt(sampler.spp))
    si = compute_differentials(scene_intersect(ctx.geom, ray), ray)
    return dict(ctx=ctx, cam=cam, film=film, sampler=sampler, integ=integ,
                si=si)


def _plain(fn):
    with K.plain_reference():
        return fn()


def _soup_dict(v):
    """Host triangle tables of the soup with vertices v (3T, 3)."""
    n = len(v) // 3
    return dict(
        tv_p=v, tv_n=np.zeros_like(v),
        tv_uv=np.zeros((len(v), 2), np.float32), tv_s=np.zeros_like(v),
        t_idx=np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
        t_material=np.zeros(n, np.int32),
        t_arealight=np.full(n, -1, np.int32),
        t_reverse=np.zeros(n, bool), t_has_n=np.zeros(n, bool),
        t_has_uv=np.zeros(n, bool), t_alpha_tex=np.full(n, -1, np.int32))


def random_soup(n_tris, seed=0, spread=4.0):
    """The random soup of tests/test_bvh.py (which imports JAX)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    return _soup_dict(np.stack([base, base + e1, base + e2], 1).reshape(-1, 3))


def random_rays(n, seed=1, spread=6.0):
    """tests/test_bvh.py's random rays -> (o, d) float32 numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _chain_binary(lo, hi, max_prims, split_method="sah"):
    """A binary tree in the SAH builder's layout that is a chain: interior
    2s holds leaf 2s+1 (triangle s) and the interior 2s+2 (the rest); the
    split method is not read."""
    n = lo.shape[0]
    m = 2 * n - 1
    nodes_lo = np.empty((m, 3), np.float32)
    nodes_hi = np.empty((m, 3), np.float32)
    meta = np.zeros((m, 3), np.int32)
    for s in range(n - 1):
        nodes_lo[2 * s], nodes_hi[2 * s] = lo[s:].min(0), hi[s:].max(0)
        meta[2 * s] = (2 * s + 2, 0, 0)
        nodes_lo[2 * s + 1], nodes_hi[2 * s + 1] = lo[s], hi[s]
        meta[2 * s + 1] = (s, 1, 0)
    nodes_lo[m - 1], nodes_hi[m - 1] = lo[n - 1], hi[n - 1]
    meta[m - 1] = (n - 1, 1, 0)
    return nodes_lo, nodes_hi, meta, np.arange(n, dtype=np.int32)


def chain_tables(n=300):
    """n triangles in the planes x = 0 .. n-1 under a chain-shaped tree,
    which collapses to 15 leaves and one subtree per wide node: a table
    n / 15 levels deep (20 for n = 300). -> (tris, wide BVH arrays)."""
    x = np.arange(n, dtype=np.float32)
    one = np.ones(n, np.float32)
    v = np.stack([np.stack([x, -one, -one], 1), np.stack([x, one, -one], 1),
                  np.stack([x, 0 * one, one], 1)], 1).reshape(-1, 3)
    tris = _soup_dict(v)
    with mock.patch.object(bvh_build, "build_binary_sah", _chain_binary):
        bvh = bvh_build.build_wide_arrays(tris["tv_p"], tris["t_idx"])
    return tris, bvh


def chain_rays(n=3072, seed=3):
    """Rays for the chain: along -x from beyond its far end (the nearest
    triangle is its deepest leaf), along +x from before its near end, and
    from inside in random directions; every 9th dead, every 4th with a
    finite t_max. -> (o, d, t_max) float32 numpy."""
    rs = np.random.default_rng(seed)
    third = (np.arange(n) // (n // 3))[:, None]
    o = np.where(third == 0, [301.0, 0.0, 0.0],
                 np.where(third == 1, [-2.0, 0.0, 0.0],
                          rs.uniform([0, -1, -1], [300, 1, 1], (n, 3))))
    o = o + rs.uniform(-0.3, 0.3, (n, 3)) * [0, 1, 1]
    d = np.where(third == 0, [-1.0, 0.0, 0.0],
                 np.where(third == 1, [1.0, 0.0, 0.0],
                          rs.normal(0, 1, (n, 3))))
    d = d + rs.normal(0, 0.01, (n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    lane = np.arange(n)
    t_max = np.where(lane % 9 == 0, 0.0,
                     np.where(lane % 4 == 0, rs.uniform(0.5, 50.0, n),
                              np.inf))
    return tuple(np.asarray(a, np.float32) for a in (o, d, t_max))


def _k1_case(request, dev, case):
    """-> (geom, o, d, t_max) on the card of a K1 test case."""
    rs = np.random.default_rng(3)
    if case == "camera":
        sc = request.getfixturevalue("scene")
        return sc["ctx"].geom, sc["ray"].o, sc["ray"].d, sc["ray"].t_max
    if case.startswith("soup"):
        # tests/test_torch_traverse16.py's soup cases: finite and infinite
        # t_max, every 7th lane dead
        n_tris = int(case[4:])
        geom = make_geometry(random_soup(n_tris, seed=11 + n_tris),
                             device=dev)
        o, d = random_rays(2048, seed=12 + n_tris)
        lane = np.arange(2048)
        t_max = np.random.default_rng(11 + n_tris).uniform(0.5, 12.0, 2048)
        t_max = np.where(lane % 7 == 0, 0.0,
                         np.where(lane % 3 == 0, np.inf, t_max))
    elif case == "dragon":
        # tests/test_torch_traverse16.py's small-dragon rays: toward the
        # mesh from the camera, and from points in and around it
        geom = request.getfixturevalue("geometry")[0]
        n = 4096
        first = (np.arange(n) < n // 2)[:, None]
        o = np.where(first, np.array([0.0, 1.1, -3.4]),
                     rs.normal(0, 1, (n, 3)) * 0.6)
        d = np.where(first, rs.uniform(-1.2, 1.2, (n, 3)) - o,
                     rs.normal(0, 1, (n, 3)))
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        t_max = np.where(np.arange(n) % 5 == 0, 0.0, np.inf)
    else:
        tris, bvh = chain_tables()
        geom = make_geometry(tris, bvh=bvh, device=dev)
        o, d, t_max = chain_rays()
    return (geom, *(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                    for a in (o, d, t_max)))


def test_sampler_bit_equal(scene):
    s, pix, smp = scene["sampler"], scene["pix"], scene["smp"]
    n0 = K.LAUNCHES["sample_2d"]
    for dim in (0, 3, 17):
        for fn in (lambda: s.get_1d(pix, smp, dim),
                   lambda: s.get_2d(pix, smp, dim)):
            assert torch.equal(fn().view(torch.int32),
                               _plain(fn).view(torch.int32))
    assert K.LAUNCHES["sample_2d"] == n0 + 3


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["camera", "soup3", "soup17", "soup400",
                                  "dragon", "deep"])
def test_traverse16_matches_plain(request, dev, case, any_hit):
    g, o, d, t_max = _k1_case(request, dev, case)
    if case == "deep":      # the stack's second register slot runs
        assert 16 < g.bvh16_depth <= MAX_DEPTH

    def fn():
        return traverse16(g, o, d, t_max, any_hit=any_hit, with_counts=True)
    n0 = K.LAUNCHES["traverse16_any" if any_hit else "traverse16_closest"]
    h, t, p, c = fn()
    # a second launch finds the ray counter the first left at 0
    again = fn()
    assert K.LAUNCHES["traverse16_any" if any_hit
                      else "traverse16_closest"] == n0 + 2
    h2, t2, p2, c2 = again
    assert torch.equal(h, h2) and torch.equal(p, p2) and torch.equal(c, c2)
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    rh, rt, rp, rc = _plain(fn)
    assert torch.equal(h, rh) and torch.equal(p, rp) and torch.equal(c, rc)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert not h[t_max <= 0].any()
    if case in ("camera", "dragon", "deep", "soup400"):
        assert h.float().mean() > 0.05


def _k2_off(field, a, b):
    """K2's lanes where a field is beyond its tolerance of the plain
    version: 1e-5 absolute or relative, p_error 1e-5 relative alone."""
    d = (a - b).abs()
    if field == "p_error":
        return d > 1e-5 * b.abs() + 1e-30
    return (d > 1e-5) & (d > 1e-5 * b.abs())


def test_build_interaction_matches_plain(scene):
    g, ray = scene["ctx"].geom, scene["ray"]
    hit, t, tid = traverse16(g, ray.o, ray.d, ray.t_max, any_hit=False)
    prim = torch.where(hit, tid + g.n_quadrics, 0)

    def fn():
        return build_interaction(g, ray, hit, t, prim)
    out, ref = fn(), _plain(fn)
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        assert not _k2_off(f, getattr(out, f), getattr(ref, f)).any(), f
    for f in ("material", "arealight", "prim_id", "valid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_film_matches_plain(scene):
    """The render's splat (box 0.5, its tile's samples and valid mask) is
    bit for bit the plain version's: a pixel takes at most two taps, and
    a + b == b + a."""
    film, p_film, v = scene["film"], scene["p_film"], scene["valid"]
    rad = torch.rand((p_film.shape[0], 3), device=p_film.device)

    def fn():
        return film.add_samples(film.init_state(p_film.device), p_film, rad,
                                valid=v)
    n0 = K.LAUNCHES["film_add_samples"]
    out, ref = fn(), _plain(fn)
    assert K.LAUNCHES["film_add_samples"] == n0 + 1
    assert torch.equal(out.rgb.view(torch.int32), ref.rgb.view(torch.int32))
    assert torch.equal(out.wsum.view(torch.int32),
                       ref.wsum.view(torch.int32))
    assert (out.wsum > 0).float().mean() > 0.9


def _film_case(dev, case):
    """-> (film, p_film, radiance, valid) of a K4 card test case."""
    width, crop, max_lum = 0.5, (0.0, 0.0, 1.0, 1.0), float("inf")
    n, res = 1 << 14, (96, 64)
    if case == "box 1.5":
        width = 1.5
    elif case == "crop":
        crop = (0.3, 0.15, 0.8, 0.9)
    elif case == "max_lum":
        max_lum = 1.25
    elif case.startswith("n="):
        n, res = int(case[2:]), (1024, 1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + len(case))
    p_film = torch.rand((n, 2), generator=gen, device=dev) \
        * torch.tensor([res[0] + 4.0, res[1] + 4.0], device=dev) - 2.0
    p_film[:8] = torch.floor(p_film[:8])         # jitter exactly 0
    rad = torch.rand((n, 3), generator=gen, device=dev) * 3.0
    valid = None if case == "valid None" else \
        torch.rand(n, generator=gen, device=dev) > 0.1
    film = Film(full_resolution=res, crop_window=crop,
                filter=Filter("box", width, width),
                max_sample_luminance=max_lum)
    return film, p_film, rad, valid


@pytest.mark.parametrize("case", ["box 1.5", "crop", "valid None",
                                  "max_lum", "n=0", "n=1",
                                  f"n={(1 << 18) + 5}"])
def test_film_cases_match_plain(dev, case):
    """K4 against its plain version, two splats into one film: overlapping
    taps (box 1.5, 3 x 3 a sample, contended reductions) within 1e-5
    relative; a crop offset, no valid mask, the luminance clamp and 0, 1
    and 2^18 + 5 samples likewise (the weights, sums of ones, exactly)."""
    film, p_film, rad, valid = _film_case(dev, case)
    n = p_film.shape[0]
    half = n // 2

    def fn():
        st = film.init_state(dev)
        for sl in (slice(0, half), slice(half, n)):
            film.add_samples(st, p_film[sl], rad[sl],
                             valid=None if valid is None else valid[sl])
        return st
    n0 = K.LAUNCHES["film_add_samples"]
    out, ref = fn(), _plain(fn)
    torch.cuda.synchronize()
    assert K.LAUNCHES["film_add_samples"] == n0 + (half > 0) + (n > half)
    torch.testing.assert_close(out.rgb, ref.rgb, rtol=1e-5, atol=1e-6)
    assert torch.equal(out.wsum, ref.wsum)
    if n > 1:
        assert (ref.wsum > 0).any()


def test_film_refuses_other_layouts(scene):
    """K4 takes only Film.init_state's views of one (H, W, 4) buffer:
    separate (H, W, 3) and (H, W) sums, the views of a buffer that is not
    16-byte aligned, or a transposed view are refused."""
    film, p_film = scene["film"], scene["p_film"]
    rad = torch.rand((p_film.shape[0], 3), device=p_film.device)
    w, h = film.cropped_resolution
    dev = p_film.device
    apart = FilmState(rgb=torch.zeros((h, w, 3), device=dev),
                      wsum=torch.zeros((h, w), device=dev))
    shifted = torch.zeros(h * w * 4 + 1, device=dev)[1:].view(h, w, 4)
    flipped = torch.zeros((w, h, 4), device=dev).transpose(0, 1)
    n0 = K.LAUNCHES["film_add_samples"]
    for st in (apart, FilmState(shifted[..., :3], shifted[..., 3]),
               FilmState(flipped[..., :3], flipped[..., 3])):
        with pytest.raises(ValueError, match="film state"):
            film.add_samples(st, p_film, rad)
    assert K.LAUNCHES["film_add_samples"] == n0
    assert not apart.rgb.any() and not apart.wsum.any()


def test_wrapper_refuses_bad_input(scene):
    g, ray = scene["ctx"].geom, scene["ray"]
    with pytest.raises(ValueError):
        traverse16(g, ray.o[:, :2], ray.d, ray.t_max, any_hit=False)
    with pytest.raises(ValueError):
        traverse16(g, ray.o.double(), ray.d, ray.t_max, any_hit=False)
    deep = dataclasses.replace(g, bvh16_depth=MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="depth"):
        traverse16(deep, ray.o, ray.d, ray.t_max, any_hit=True)


def _assert_render_matches_plain(renderer, ctx, **kw):
    img = renderer.film.to_image(renderer.render_state(ctx, **kw))
    with K.plain_reference():
        ref = renderer.film.to_image(renderer.render_state(ctx, **kw))
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-4
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    assert err.mean() / scale <= 2e-3
    assert np.percentile(err, 99) / scale <= 2e-2


def test_render_matches_plain(scene):
    K.reset_launches()
    _assert_render_matches_plain(scene["renderer"], scene["ctx"])
    assert all(K.LAUNCHES[k] > 0 for k in MATTE_KERNELS), K.LAUNCHES
    # no quadric in the dragon: its dummy row is never searched
    assert all(K.LAUNCHES[k] == 0 for k in K.QUADRIC_KERNELS), K.LAUNCHES


def _ewa_inputs(dev, wrap, n=1 << 14, pattern="random"):
    """Three small pyramids, four registrations of wrap mode ``wrap``, and n
    lanes with uv in [-0.5, 1.5], random differentials on 3/4 of them and
    zeros on the rest; textured lanes (reg >= 0) by ``pattern``: "random"
    (reg = -1 on about a fifth), "none", "all", "alternating" (the even
    lanes, so every warp mixes both) or "coarse" (about 1% of the lanes,
    all with differentials of 0.03-3 that put them on the coarsest levels,
    where many lanes add into one texel: an interior bounce)."""
    rs = np.random.RandomState(11)
    images = [build_pyramid(rs.rand(*s).astype(np.float32))
              for s in ((64, 64, 3), (12, 20, 3), (8, 8))]
    meta = A.build_atlas_meta(images)

    texs = [SimpleNamespace(
        image_id=i % 3, wrap=wrap, scale=[1.0, 0.5, 2.0, 1.25][i],
        mapping=SimpleNamespace(su=[1.0, 3.0, 0.5, 2.0][i],
                                sv=[1.0, 2.0, 1.5, 0.75][i],
                                du=[0.0, 0.25, -0.1, 0.5][i],
                                dv=[0.0, -0.5, 0.3, 0.0][i]))
        for i in range(4)]
    regs = A.registrations_on(A.build_registrations(texs), dev)
    scale = 10.0 ** rs.uniform(-4, -0.5, (n, 4))
    sign = np.where(rs.rand(n, 4) < 0.5, -1.0, 1.0)
    diffs = scale * sign * (rs.rand(n, 1) < 0.75)
    if pattern == "coarse":
        diffs = 10.0 ** rs.uniform(-1.5, 0.5, (n, 4)) * sign
    diffs = torch.as_tensor(diffs.astype(np.float32), device=dev)
    si = SimpleNamespace(
        uv=torch.as_tensor(rs.uniform(-0.5, 1.5, (n, 2)).astype(np.float32),
                           device=dev),
        dudx=diffs[:, 0].contiguous(), dvdx=diffs[:, 1].contiguous(),
        dudy=diffs[:, 2].contiguous(), dvdy=diffs[:, 3].contiguous())
    reg = rs.randint(-1 if pattern == "random" else 0, 4, n)
    if pattern == "none":
        reg[:] = -1
    elif pattern == "alternating":
        reg[1::2] = -1
    elif pattern == "coarse":
        reg[rs.rand(n) >= 0.01] = -1
    reg = torch.as_tensor(reg.astype(np.int32), device=dev)
    timg = [[torch.as_tensor(lv) for lv in p] for p in images]
    return (timg, torch.as_tensor(meta["atlas_meta"], device=dev),
            torch.as_tensor(meta["atlas_levels"], device=dev), regs, reg, si)


def _ewa_close(out, ref, reg):
    if not out.shape[0]:
        return
    bad = ((out - ref).abs().max(-1).values > 1e-5).float().mean().item()
    assert bad <= 1e-3, bad
    assert torch.equal(out[reg < 0], torch.zeros_like(out[reg < 0]))


@pytest.mark.parametrize("n", [0, 1, 127, 129, 1 << 14, (1 << 18) + 5])
@pytest.mark.parametrize("pattern", ["random", "none", "all", "alternating"])
@pytest.mark.parametrize("quad,wrap", [(True, WRAP_REPEAT),
                                       (False, WRAP_REPEAT),
                                       (False, WRAP_BLACK),
                                       (False, WRAP_CLAMP)])
def test_atlas_ewa_matches_plain(dev, quad, wrap, pattern, n):
    """K5's tiles of 128 lanes pack their textured lanes: whole, empty,
    mixed in every warp, and ragged at the end of the wavefront."""
    timg, meta, levels, regs, reg, si = _ewa_inputs(dev, wrap, n, pattern)
    texels = (A.atlas_quad_texels if quad else A.atlas_texels)(timg).to(dev)
    n0 = K.LAUNCHES["atlas_lookup_ewa"]

    def fn():
        return A.atlas_lookup_ewa(texels, meta, levels, regs, reg, si,
                                  quad=quad)
    out, ref = fn(), _plain(fn)
    torch.cuda.synchronize()
    assert K.LAUNCHES["atlas_lookup_ewa"] == n0 + (n > 0)
    assert out.shape == ref.shape == (n, 3)
    _ewa_close(out, ref, reg)
    if pattern != "none" and n >= 127:
        assert ref.abs().max() > 0.1


def test_atlas_ewa_layouts_agree_on_dragon(textured):
    """The hero texture at the camera hits: K5 in both layouts against the
    plain version; the two layouts read the same texels."""
    ctx, ms, si = textured["ctx"], textured["integ"].mat_set, textured["si"]
    dev = si.t.device
    quad, texels, regs, slots = ms.atlas_tables(ctx.textures, dev)
    assert quad
    reg = slots[si.material.clamp(0, len(ms.materials) - 1).long(), 0]
    reg = reg.contiguous()
    assert (reg >= 0).float().mean() > 0.2
    meta, levels = ctx.textures["atlas_meta"], ctx.textures["atlas_levels"]
    flat = A.atlas_texels(ctx.textures["images"]).to(dev)
    outs = []
    for q, tex in ((True, texels), (False, flat)):
        def fn(q=q, tex=tex):
            return A.atlas_lookup_ewa(tex, meta, levels, regs, reg, si,
                                      quad=q)
        out, ref = fn(), _plain(fn)
        _ewa_close(out, ref, reg)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def real_alive(textured):
    """The alive mask after bounce 0 of the 64^2 textured dragon's 4096
    camera lanes."""
    t = textured
    dev = t["si"].t.device
    py, px = torch.meshgrid(torch.arange(64, device=dev),
                            torch.arange(64, device=dev), indexing="ij")
    px, py = px.ravel(), py.ravel()
    pix = py.long() * 64 + px.long()
    lanes = Lanes(pixel_idx=pix, sample_idx=torch.zeros_like(pix))
    p_film, _, _ = t["sampler"].get_camera_sample(
        torch.stack([px, py], -1).float(), lanes.pixel_idx,
        lanes.sample_idx)
    ray = t["cam"].generate_ray_differential(p_film).scaled_differentials(
        1.0 / np.sqrt(t["sampler"].spp))
    return t["integ"].bounce0(t["ctx"], ray, lanes, t["sampler"],
                              DimAllocator()).alive


def _masks(n, gen, real):
    dev = real.device
    for frac in (0.0, 0.25, 0.5, 0.9, 1.0):
        yield f"{frac} alive", torch.rand(n, generator=gen, device=dev) < frac
    yield "alternating", torch.arange(n, device=dev) % 2 == 0
    yield "real", real.repeat(-(-n // real.shape[0]))[:n].contiguous()


@pytest.mark.parametrize("n", [1, 1000, 1023, 1024, 1025, 1 << 18,
                               (1 << 18) + 3, (1 << 18) + 123, 1 << 20])
def test_alive_first_order_bit_equal(dev, real_alive, n):
    """K6 is one launch a call and bit-equal with the stable argsort, its
    rank and count, on three calls in a row: each call finds the status
    words the one before left at 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    for label, alive in _masks(n, gen, real_alive):
        ref = _plain(lambda: C.alive_first_order(alive))
        assert torch.equal(ref[0], torch.argsort(~alive, stable=True).int())
        for _ in range(3):
            n0 = K.LAUNCHES["alive_first_order"]
            out = C.alive_first_order(alive)
            assert K.LAUNCHES["alive_first_order"] == n0 + 1
            for a, b in zip(out, ref):
                assert a.dtype == b.dtype == torch.int32
                assert torch.equal(a, b), label


def test_alive_first_order_two_streams_and_unaligned(dev, real_alive):
    """Two streams each keep their own status words; a mask that does not
    start on a 16-byte boundary takes the byte loads."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    masks = [torch.rand((1 << 18) + 3, generator=gen, device=dev) < 0.4,
             real_alive.repeat(300).contiguous()]
    refs = [_plain(lambda a=a: C.alive_first_order(a)) for a in masks]
    streams = [torch.cuda.Stream(dev) for _ in masks]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(4):
        for k, (s, a) in enumerate(zip(streams, masks)):
            with torch.cuda.stream(s):
                outs[k].append(C.alive_first_order(a))
    torch.cuda.synchronize()
    for k in range(2):
        for out in outs[k]:
            assert all(torch.equal(x, y) for x, y in zip(out, refs[k]))
    base = torch.rand((1 << 16) + 9, generator=gen, device=dev) < 0.5
    alive = base[1:]
    assert alive.data_ptr() % 16
    out = C.alive_first_order(alive)
    ref = _plain(lambda: C.alive_first_order(alive))
    assert all(torch.equal(x, y) for x, y in zip(out, ref))


def test_slab_take_put_match_plain(dev):
    n = (1 << 16) + 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    alive = torch.rand(n, generator=gen, device=dev) < 0.3
    fields = [torch.rand((n, 3), generator=gen, device=dev),
              torch.rand(n, generator=gen, device=dev),
              torch.rand(n, generator=gen, device=dev) < 0.5,
              torch.randint(0, 1 << 32, (n,), generator=gen, device=dev)]
    order, _, _ = C.alive_first_order(alive)
    n0 = dict(K.LAUNCHES)
    for w in (n // 2, n // 4):
        subs = C.slab_take(fields, order, w)
        ref = _plain(lambda: C.slab_take(fields, order, w))
        assert all(torch.equal(a, b) for a, b in zip(subs, ref))
        back = C.slab_put([torch.zeros_like(f) for f in fields], subs,
                          order, w)
        ref = _plain(lambda: C.slab_put([torch.zeros_like(f)
                                         for f in fields], subs, order, w))
        assert all(torch.equal(a, b) for a, b in zip(back, ref))
    assert K.LAUNCHES["slab_take"] == n0["slab_take"] + 2
    assert K.LAUNCHES["slab_put"] == n0["slab_put"] + 2


_SLAB_N = 70001   # not a multiple of K7's 256-lane blocks


@pytest.fixture(scope="module")
def slab_fields(dev):
    """Fields of 1, 4, 8 and 12 bytes a lane (bool, uint8, float32, int32,
    int64, (n, 3) float32) over _SLAB_N lanes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    n = _SLAB_N
    return [torch.rand((n, 3), generator=gen, device=dev),
            torch.rand(n, generator=gen, device=dev) < 0.5,
            torch.randint(0, 255, (n,), generator=gen, device=dev,
                          dtype=torch.uint8),
            torch.rand(n, generator=gen, device=dev),
            torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                          device=dev, dtype=torch.int64),
            torch.rand((n, 3), generator=gen, device=dev) - 0.5]


@pytest.mark.parametrize("kind", ["alive first", "permutation"])
@pytest.mark.parametrize("w", [0, 1, _SLAB_N // 4, _SLAB_N // 2, _SLAB_N])
def test_slab_moves_bit_equal(dev, slab_fields, kind, w):
    """K7's take and put, bit for bit the plain versions, each one launch
    (none for an empty slab), for slab widths from 0 to n, on an
    alive-first order and on a random permutation."""
    n = _SLAB_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(w)
    if kind == "alive first":
        order, _, _ = C.alive_first_order(
            torch.rand(n, generator=gen, device=dev) < 0.4)
    else:
        order = torch.randperm(n, generator=gen, device=dev).int()
    fields = slab_fields
    n0 = dict(K.LAUNCHES)
    subs = C.slab_take(fields, order, w)
    ref = _plain(lambda: C.slab_take(fields, order, w))
    assert K.LAUNCHES["slab_take"] == n0["slab_take"] + (w > 0)
    for a, b in zip(subs, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    # the put writes over fields that hold other values, so a lane it
    # misses shows
    base = [f.flip(0).contiguous() for f in fields]
    out = C.slab_put([f.clone() for f in base], subs, order, w)
    assert K.LAUNCHES["slab_put"] == n0["slab_put"] + (w > 0)
    ref = _plain(lambda: C.slab_put([f.clone() for f in base], subs, order,
                                    w))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", [128, 16, 4])
def test_row_gather_equal(dev, width):
    gen = torch.Generator(device=dev)
    gen.manual_seed(width)
    table = torch.rand((4099, width), generator=gen, device=dev)
    idx = torch.randint(0, 4099, ((1 << 16) + 5,), generator=gen,
                        device=dev, dtype=torch.int32)
    assert torch.equal(row_gather(table, idx), table[idx.long()])
    with pytest.raises(ValueError):
        row_gather(table[:, :width // 2 + 1], idx)


@pytest.mark.parametrize("width", [96, 112])
def test_row_gather_layered_widths(dev, width):
    """K8 at the widths of Disney's rows (6 lobes of 16 floats) and a mix
    of substrate and Disney (7): few distinct rows over 2^18 lanes, as a
    render gathers them, bit for bit with the plain version."""
    from rustracer_tpu_torch.ops.gather import row_gather_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(width)
    table = torch.rand((5, width), generator=gen, device=dev)
    idx = torch.randint(0, 5, (1 << 18,), generator=gen, device=dev,
                        dtype=torch.int32)
    n0 = K.LAUNCHES["row_gather"]
    out = row_gather(table, idx)
    assert K.LAUNCHES["row_gather"] == n0 + 1
    assert torch.equal(out.view(torch.int32),
                       row_gather_plain(table, idx).view(torch.int32))


def test_textured_render_matches_plain(textured, monkeypatch):
    """The 64^2 textured dragon, 1 sample, with the slab tiers opened to
    its 4096-lane tile: every forward kernel launches, a slab tier runs."""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 1024)
    t = textured
    r = Renderer(t["integ"].li, t["cam"], t["film"], t["sampler"],
                 RenderConfig(max_lanes=1024), device=t["si"].t.device)
    K.reset_launches()
    P.reset_tiers()
    _assert_render_matches_plain(r, t["ctx"], sample_stop=1)
    assert all(K.LAUNCHES[k] > 0 for k in K.FORWARD_KERNELS), K.LAUNCHES
    assert P.TIERS[2] + P.TIERS[4] > 0, P.TIERS


# ---------------------------------------------------------------------------
# the gradient path: K9-K11, K7 as its own transpose, the launch guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["box 0.5", "box 1.5", "crop", "valid None",
                                  "max_lum", "n=0", "n=1",
                                  f"n={(1 << 18) + 5}"])
def test_film_bwd_matches_plain(dev, case):
    """K9, the splat's radiance gradient, is bit for bit its plain version:
    a gather in the plain version's tap order (no atomics), the clamp's
    VJP op for op; one launch (none for no samples)."""
    film, p_film, rad, valid = _film_case(dev, case)
    w, h = film.cropped_resolution
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    g_acc = torch.rand((h, w, 4), generator=gen, device=dev) - 0.5
    n0 = K.LAUNCHES["film_add_samples_bwd"]
    out = film.add_samples_bwd(g_acc, p_film, rad, valid)
    assert K.LAUNCHES["film_add_samples_bwd"] == n0 + (p_film.shape[0] > 0)
    ref = _plain(lambda: film.add_samples_bwd(g_acc, p_film, rad, valid))
    assert out.shape == ref.shape == rad.shape
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def _sums_close(out, ref, ref_abs):
    """Scatter-added sums against the plain version's, taken in another
    order by atomics: each within 1e-4 of the sum of its terms' magnitudes
    ``ref_abs`` (the plain version on |g|), which bounds the rounding of a
    float32 sum of thousands of terms in any order with room to spare."""
    assert out.shape == ref.shape
    tol = 1e-4 * ref_abs + 1e-7 * ref_abs.max()
    assert bool(((out - ref).abs() <= tol).all()), \
        ((out - ref).abs() / tol.clamp(min=1e-30)).max()


@pytest.mark.parametrize("n", [0, 1, 129, 1 << 14, (1 << 18) + 5])
@pytest.mark.parametrize("pattern", ["random", "all", "alternating",
                                     "coarse"])
@pytest.mark.parametrize("quad,wrap", [(True, WRAP_REPEAT),
                                       (False, WRAP_REPEAT),
                                       (False, WRAP_BLACK),
                                       (False, WRAP_CLAMP)])
def test_atlas_bwd_matches_plain(dev, quad, wrap, pattern, n):
    """K10, the texel gradient of the EWA lookup, against autograd of the
    plain lookup (on the quad rows built from the (T, 3) texels for the
    quad layout), as sums taken in another order (_sums_close): tiles of
    its persistent blocks whole, empty, mixed and ragged, and sparse lanes
    on the coarse levels, whose adds meet in each block's hash."""
    timg, meta, levels, regs, reg, si = _ewa_inputs(dev, wrap, n, pattern)
    texels = A.atlas_texels(timg).to(dev)
    qidx = A.atlas_quad_index(timg).to(dev) if quad else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    g = torch.rand((n, 3), generator=gen, device=dev) - 0.5
    n0 = K.LAUNCHES["atlas_lookup_ewa_bwd"]
    out = A.atlas_lookup_ewa_bwd(g, texels, meta, levels, regs, reg, si,
                                 qidx)
    assert K.LAUNCHES["atlas_lookup_ewa_bwd"] == n0 + (n > 0)
    ref, ref_abs = (_plain(lambda x=x: A.atlas_lookup_ewa_bwd(
        x, texels, meta, levels, regs, reg, si, qidx)) for x in (g, g.abs()))
    _sums_close(out, ref, ref_abs)
    if n > 1 and (pattern != "coarse" or n >= 1 << 14):
        assert ref.abs().max() > 0


@pytest.mark.parametrize("rows,width", [(3, 16), (5, 16), (3001, 4),
                                        (8, 16), (9, 16), (1, 4), (8, 32)])
def test_row_gather_bwd_matches_plain(dev, rows, width):
    """K11, the table gradient of the row gather, against index_add_ as
    sums taken in another order (_sums_close), on 2^18 + 5 lanes (not a
    multiple of a block's lanes): the register path up to 8 rows (of 4 to
    32 floats), the shared-copy path beyond; a table gradient beyond the
    shared memory K11 sums in is refused."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows)
    n = (1 << 18) + 5
    g = torch.rand((n, width), generator=gen, device=dev) - 0.5
    idx = torch.randint(0, rows, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    from rustracer_tpu_torch.ops.gather import row_gather_bwd
    n0 = K.LAUNCHES["row_gather_bwd"]
    out = row_gather_bwd(g, idx, rows)
    assert K.LAUNCHES["row_gather_bwd"] == n0 + 1
    _sums_close(out, _plain(lambda: row_gather_bwd(g, idx, rows)),
                _plain(lambda: row_gather_bwd(g.abs(), idx, rows)))
    with pytest.raises(ValueError, match="shared memory"):
        row_gather_bwd(torch.zeros((4, 16), device=dev),
                       torch.zeros(4, dtype=torch.int32, device=dev), 1024)


@pytest.mark.parametrize("n", [1, 33, 1000, (1 << 18) + 5])
@pytest.mark.parametrize("rows", [3, 8])
def test_row_gather_bwd_reproducible(dev, rows, n):
    """K11's register path sums in a fixed order: two launches give the
    same bits, from a grid of one block to one block an SM, and a g that
    starts off a 16-byte boundary is read as well."""
    from rustracer_tpu_torch.ops.gather import row_gather_bwd
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    buf = torch.rand((n * 16 + 1,), generator=gen, device=dev) - 0.5
    idx = torch.randint(0, rows, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    for g in (buf[:-1].view(n, 16), buf[1:].view(n, 16)):
        out = row_gather_bwd(g, idx, rows)
        assert torch.equal(out.view(torch.int32),
                           row_gather_bwd(g, idx, rows).view(torch.int32))
        _sums_close(out, _plain(lambda: row_gather_bwd(g, idx, rows)),
                    _plain(lambda: row_gather_bwd(g.abs(), idx, rows)))


@pytest.mark.parametrize("w", [0, 1, _SLAB_N // 4, _SLAB_N // 2, _SLAB_N])
def test_slab_transposes_bit_equal(dev, slab_fields, w):
    """K7 as its own transpose: the take's backward (a put into zeros) and
    the put's (a take, and a put of zeros) bit for bit the plain versions
    on the float fields, one launch each (none for an empty slab)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(w + 1)
    n = _SLAB_N
    order, _, _ = C.alive_first_order(
        torch.rand(n, generator=gen, device=dev) < 0.4)
    full = [f for f in slab_fields if f.is_floating_point()]
    shapes = [(f.shape, f.dtype) for f in full]
    subs = [torch.rand((w,) + tuple(f.shape[1:]), generator=gen,
                       device=dev) for f in full]
    n0 = dict(K.LAUNCHES)
    out = C.take_transpose(order, w, subs, shapes)
    assert K.LAUNCHES["slab_put"] == n0["slab_put"] + (w > 0)
    ref = _plain(lambda: C.take_transpose(order, w, subs, shapes))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    n0 = dict(K.LAUNCHES)
    out = C.put_transpose(order, w, full)
    assert K.LAUNCHES["slab_take"] == n0["slab_take"] + (w > 0)
    assert K.LAUNCHES["slab_put"] == n0["slab_put"] + (w > 0)
    ref = _plain(lambda: C.put_transpose(order, w, full))
    for a, b in zip(out[0] + out[1], ref[0] + ref[1]):
        assert torch.equal(a, b)


def test_launch_guard_raises_on_requires_grad(dev):
    """With grad mode on, a kernel given a tensor that requires grad
    outside this package's autograd Functions raises (a ctypes launch
    would cut the graph); inside ``differentiable()`` and under no_grad
    it launches."""
    table = torch.rand((8, 16), device=dev, requires_grad=True)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    out = torch.empty((4, 16), device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.launch("row_gather", table, idx, 4, 16, out)
    fields = [torch.rand((64, 3), device=dev, requires_grad=True)]
    order = torch.arange(64, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        C.slab_move("slab_take", order, 32, fields,
                    [torch.empty((32, 3), device=dev)])
    with K.differentiable():
        K.launch("row_gather", table, idx, 4, 16, out)
    with torch.no_grad():
        K.launch("row_gather", table, idx, 4, 16, out)
    assert torch.equal(out, table.detach()[idx.long()])
    # the differentiable wrapper carries the gradient
    row_gather(table, idx).sum().backward()
    assert torch.equal(table.grad[0], torch.full((16,), 4.0, device=dev))


def test_train_step_matches_plain(textured, monkeypatch):
    """One train step of the 64^2 textured dragon (1024-lane tiles, slab
    tiers opened), kernel path against the all-plain path: the same loss
    within 1e-5 relative, the gradients of every float leaf within the
    bound of the CPU parity test (1e-3 of the norm, 1e-2 of the largest
    entry), every backward kernel launched, a slab tier taken."""
    from rustracer_tpu_torch.parallel.mesh import (float_leaves, grad_errors,
                                                   make_train_step)
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 1024)
    t = textured
    dev = t["si"].t.device
    step = make_train_step(t["integ"].li, t["cam"], t["film"], t["sampler"],
                           lr=1.0, config=RenderConfig(max_lanes=1024),
                           device=dev)
    target = torch.full((64, 64, 3), 0.05, device=dev)
    leaves, _ = float_leaves(t["ctx"].textures)
    K.reset_launches()
    P.reset_tiers()
    new, loss = step(t["ctx"], target)
    torch.cuda.synchronize()
    # the dragon looks no image up per texture: no K20
    assert all(K.LAUNCHES[k] > 0 for k in K.BACKWARD_KERNELS
               if k != "mipmap_lookup_bwd"), K.LAUNCHES
    # a slab step: take and put forward; a put (the take's transpose), a
    # take and a put (the put's) backward
    slabs = P.TIERS[2] + P.TIERS[4]
    assert slabs > 0, P.TIERS
    assert K.LAUNCHES["slab_take"] == 2 * slabs
    assert K.LAUNCHES["slab_put"] == 3 * slabs
    with K.plain_reference():
        new_p, loss_p = step(t["ctx"], target)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    grads = [p - q for p, q in zip(leaves, float_leaves(new.textures)[0])]
    refs = [p - q for p, q in zip(leaves, float_leaves(new_p.textures)[0])]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    rel, elem = grad_errors(grads, refs)
    assert rel <= 1e-3 and elem <= 1e-2, (rel, elem)
    assert max(g.abs().max().item() for g in refs) > 0


# ---------------------------------------------------------------------------
# the scene front end: K4 and K9 with every filter, the light grid (K12,
# K13), a parsed scene
# ---------------------------------------------------------------------------

FILTER_KINDS = {"triangle": Filter("triangle", 2.0, 2.0),
                "gaussian": Filter("gaussian", 2.0, 1.5, alpha=3.0),
                "mitchell": Filter("mitchell", 2.0, 2.0),
                "mitchell 4": Filter("mitchell", 4.0, 4.0, b=0.5, c=0.25)}


def _rows_case(dev, film, case):
    """A renderer's order over ``film``'s sample bounds: two passes,
    row-major, the first sample on column 37 of its row (a tile that
    starts mid-row), jitter 0 and 0.5 on some; the crop cuts rows and
    columns. "rows permuted" shuffles the samples."""
    film = dataclasses.replace(film, crop_window=(0.1, 0.05, 0.9, 0.95))
    sx0, sy0, sx1, sy1 = film.get_sample_bounds()
    wd, ht = sx1 - sx0, sy1 - sy0
    n = 2 * wd * ht
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pix = (torch.arange(n, device=dev) + 37) % (wd * ht)
    p_film = torch.stack([pix % wd + sx0, pix // wd + sy0], -1).float() \
        + torch.rand((n, 2), generator=gen, device=dev)
    p_film[1::7] = torch.floor(p_film[1::7]) + 0.5     # jitter 0.5
    p_film[2::11] = torch.floor(p_film[2::11])          # jitter 0
    rad = torch.rand((n, 3), generator=gen, device=dev) * 3.0
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    if case == "rows permuted":
        perm = torch.randperm(n, generator=gen, device=dev)
        p_film, rad, valid = p_film[perm], rad[perm], valid[perm]
    return film, p_film.contiguous(), rad.contiguous(), valid.contiguous()


@pytest.mark.parametrize("kind", sorted(FILTER_KINDS))
@pytest.mark.parametrize("case", ["crop", "max_lum", f"n={(1 << 16) + 3}",
                                  "rows", "rows permuted"])
def test_film_filters_match_plain(dev, kind, case):
    """K4 and K9 with each filter against their plain versions: the film
    within 1e-5 relative (1e-6 absolute; contended reductions, K4's warp
    sums in another order, and the plain version's exp and divides by a
    number round differently on the card), the radiance gradient
    likewise, the triangle's bit for bit (its weights and K9's sums in the
    plain version's order); one launch each. "rows" lays the samples out
    as a renderer does (a warp's lanes on 32 consecutive pixels of a row):
    K4's warp-summed path for footprints of up to 4 x 4 taps; the other
    cases, and "mitchell 4" (8 x 8), its per-tap path. K9 for footprints
    of up to 4 x 4 (the Gaussian's 4 x 3 included) reads the taps from the
    block's box in shared memory where its samples lie as the renderer
    lays them out ("rows", but for the blocks where the second pass
    starts) and from global memory elsewhere; "mitchell 4" takes its
    tap-by-tap kernel."""
    film, p_film, rad, valid = _film_case(dev, case)
    film = dataclasses.replace(film, filter=FILTER_KINDS[kind])
    if case.startswith("rows"):
        film, p_film, rad, valid = _rows_case(dev, film, case)

    def fn():
        return film.add_samples(film.init_state(dev), p_film, rad,
                                valid=valid)
    n0 = K.LAUNCHES["film_add_samples"]
    out, ref = fn(), _plain(fn)
    assert K.LAUNCHES["film_add_samples"] == n0 + 1
    torch.testing.assert_close(out.rgb, ref.rgb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out.wsum, ref.wsum, rtol=1e-5, atol=1e-6)
    assert (ref.wsum > 0).float().mean() > 0.2
    w, h = film.cropped_resolution
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    g_acc = torch.rand((h, w, 4), generator=gen, device=dev) - 0.5
    n0 = K.LAUNCHES["film_add_samples_bwd"]
    out = film.add_samples_bwd(g_acc, p_film, rad, valid)
    assert K.LAUNCHES["film_add_samples_bwd"] == n0 + 1
    ref = _plain(lambda: film.add_samples_bwd(g_acc, p_film, rad, valid))
    if kind == "triangle":
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


def test_random_sampler_bit_equal(dev):
    """K3r (the random sampler's kernels) bit for bit with their plain
    versions on seeded uint32 pixel and sample ids, one launch a call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    pix = torch.randint(0, 1 << 32, ((1 << 16) + 7,), generator=gen,
                        device=dev, dtype=torch.int64)
    smp = torch.randint(0, 1 << 32, pix.shape, generator=gen, device=dev,
                        dtype=torch.int64)
    s = SamplerConfig(kind="random", spp=3, seed=11)
    for name, fn in (("sample_random_1d", lambda d: s.get_1d(pix, smp, d)),
                     ("sample_random_2d", lambda d: s.get_2d(pix, smp, d))):
        for dim in (0, 5, (1 << 32) - 1):
            n0 = K.LAUNCHES[name]
            out = fn(dim)
            assert K.LAUNCHES[name] == n0 + 1
            assert torch.equal(out.view(torch.int32),
                               _plain(lambda: fn(dim)).view(torch.int32))


@pytest.mark.parametrize("kind", ["box", "triangle", "mitchell",
                                  "gaussian"])
def test_det_splat_matches_plain(dev, kind):
    """K4d on two tiles of a renderer's lanes (the second starting
    mid-row and padded past the sample bounds with invalid lanes, as the
    renderer pads; some lanes invalid, a crop, the luminance clamp on about
    half the lanes) against
    its plain version: bit for bit (its sums in the plain version's order;
    within 1e-5 relative for the Gaussian, whose plain exp rounds
    otherwise on the card, as test_film_filters_match_plain says), the
    same bits on a second launch, and a sample outside its lane's pixel
    refused."""
    filt = {"box": Filter("box", 0.5, 0.5), "triangle":
            Filter("triangle", 2.0, 2.0), "mitchell": Filter("mitchell", 2.0,
                                                           2.0),
            "gaussian": Filter("gaussian", 2.0, 1.5, alpha=3.0)}[kind]
    film = Film(full_resolution=(300, 200), filter=filt,
                crop_window=(0.1, 0.05, 0.9, 0.95), max_sample_luminance=4.0)
    sx0, sy0, sx1, sy1 = film.get_sample_bounds()
    total = (sx1 - sx0) * (sy1 - sy0)
    runs = []
    for _ in range(2):
        out, ref = film.init_state(dev), film.init_state(dev)
        for first, n in ((0, 20000), (20000, total - 20000 + 137)):
            lx, ly, lane = film.lane_pixels(first, n, dev)
            g = torch.Generator(device=dev)
            g.manual_seed(first)
            p_film = torch.stack([lx, ly], -1).float() + torch.rand(
                (n, 2), generator=g, device=dev)
            # about half the lanes above the clamp's luminance of 4
            rad = torch.rand((n, 3), generator=g, device=dev) * 8.0
            valid = (torch.rand(n, generator=g, device=dev) > 0.1) \
                & (lane < total)
            clamped = (film._clamped(rad) != rad).any(-1).float().mean()
            assert 0.2 < clamped < 0.8
            n0 = K.LAUNCHES["film_add_samples_det"]
            film.add_samples_det(out, p_film, rad, valid, first)
            assert K.LAUNCHES["film_add_samples_det"] == n0 + 1
            _plain(lambda: film.add_samples_det(ref, p_film, rad, valid,
                                                first))
        runs.append(out)
        for a, b in zip(out[:2], ref[:2]):
            if kind == "gaussian":
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (runs[0].wsum > 0).float().mean() > 0.5
    assert torch.equal(runs[0].rgb.view(torch.int32),
                       runs[1].rgb.view(torch.int32))
    with pytest.raises(ValueError, match="renderer's lanes"):
        film.add_samples_det(film.init_state(dev), p_film.flip(0), rad,
                             None, first)


# K4d's tiled kernel against its plain version: (filter, film, crop, the
# lanes' first index and count, the share of invalid lanes). Lanes start
# and end mid-row; the 3-wide Gaussian's footprint (6 taps an axis) is
# wider than the tiles' kMaxAxisTaps and takes the per-pixel kernel.
DET_TILE_CASES = {
    "box": (Filter("box", 0.5, 0.5), (203, 77), (0, 0, 1, 1), 45, 9000,
            0.0),
    "triangle": (Filter("triangle", 2.0, 2.0), (203, 77), (0, 0, 1, 1),
                 101, 12000, 0.2),
    "gaussian": (Filter("gaussian", 2.0, 2.0, alpha=2.0), (203, 77),
                 (0, 0, 1, 1), 317, 11000, 0.2),
    "mitchell": (Filter("mitchell", 2.0, 2.0), (203, 77), (0, 0, 1, 1), 13,
                 15000, 0.0),
    "mitchell crop": (Filter("mitchell", 2.0, 2.0), (300, 130),
                      (0.13, 0.21, 0.71, 0.9), 777, 8000, 0.3),
    "triangle 1.3 x 1.9": (Filter("triangle", 1.3, 1.9), (150, 90),
                           (0, 0.1, 0.9, 1), 59, 9000, 0.25),
    "gaussian wide": (Filter("gaussian", 3.0, 3.0, alpha=2.0), (150, 90),
                      (0.05, 0, 1, 0.8), 211, 7000, 0.25),
}


@pytest.mark.parametrize("case", list(DET_TILE_CASES))
def test_det_splat_tiles_match_plain(dev, case):
    """K4d (csrc/film.cu: 32 x 16-pixel tiles over the lanes staged in
    shared memory; footprints wider than 4 taps an axis per pixel) on a
    run of a renderer's lanes that starts and ends mid-row, some invalid,
    the luminance clamp on: bit for bit with Film.add_samples_det_plain
    (the Gaussian within 1e-5 relative: its plain exp rounds otherwise on
    the card, test_det_splat_matches_plain), and bit for bit over two
    launches."""
    filt, res, crop, first, n, holes = DET_TILE_CASES[case]
    film = Film(full_resolution=res, filter=filt, crop_window=crop,
                max_sample_luminance=3.0)
    sx0, sy0, sx1, sy1 = film.get_sample_bounds()
    n = min(n, (sx1 - sx0) * (sy1 - sy0) - first)
    assert first % (sx1 - sx0) and (first + n) % (sx1 - sx0)
    lx, ly, _ = film.lane_pixels(first, n, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(first)
    p_film = torch.stack([lx, ly], -1).float() + torch.rand(
        (n, 2), generator=g, device=dev)
    p_film[:7] = torch.stack([lx[:7], ly[:7]], -1).float()
    rad = torch.rand((n, 3), generator=g, device=dev) * 6.0
    valid = (torch.rand(n, generator=g, device=dev) >= holes) if holes \
        else None
    outs = []
    for _ in range(2):
        n0 = K.LAUNCHES["film_add_samples_det"]
        outs.append(film.add_samples_det(film.init_state(dev), p_film, rad,
                                         valid, first))
        assert K.LAUNCHES["film_add_samples_det"] == n0 + 1
    ref = _plain(lambda: film.add_samples_det(film.init_state(dev), p_film,
                                              rad, valid, first))
    assert (ref.wsum != 0).float().mean() > 0.3
    for a, b in zip(outs[0][:2], ref[:2]):
        if filt.kind == "gaussian":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def parsed_cornell(dev):
    import os
    from rustracer_tpu_torch.scene.api import parse_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "cornell-box.pbrt")
    K.reset_launches()
    bundle = parse_scene(path, device=dev).scene
    launches = dict(K.LAUNCHES)
    return bundle, launches


def test_grid_contrib_matches_plain(parsed_cornell):
    """K12 on the Cornell box's whole 64 x 63 x 64 grid against its plain
    version: each sum within 1e-5 relative (the approximate reciprocal
    square root and the sums' order), 1e-6 of the largest absolute; the
    parse launched K12 once, and so does each call."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    bundle, launches = parsed_cornell
    assert launches["spatial_grid_contrib"] == 1
    lt, dev = bundle.lights, bundle.device
    lo = bundle.geom.tv_p.min(0).values.cpu().numpy()
    hi = bundle.geom.tv_p.max(0).values.cpu().numpy()
    nv, _, ext = LD.voxels(lo, hi)
    assert tuple(int(x) for x in nv) == (64, 63, 64)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)
    n0 = K.LAUNCHES["spatial_grid_contrib"]
    out = LD.grid_contrib(lt, lo, ext, nv, halton)
    assert K.LAUNCHES["spatial_grid_contrib"] == n0 + 1
    ref = _plain(lambda: LD.grid_contrib(lt, lo, ext, nv, halton))
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-6 * ref.abs().max().item())
    assert (ref > 0).float().mean() > 0.5


@pytest.mark.parametrize("n", [1, 1000, (1 << 18) + 7])
def test_light_pick_and_pmf_bit_equal(parsed_cornell, n):
    """K13's pick and lookup are bit for bit their plain versions (the
    same float voxel map, a count, gathers), points inside and around the
    scene's bounds, u on cdf entries included."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    bundle, _ = parsed_cornell
    grid, dev = bundle.light_grid, bundle.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    lo, hi = bundle.geom.tv_p.min(0).values, bundle.geom.tv_p.max(0).values
    p = lo - 10 + torch.rand((n, 3), generator=gen, device=dev) \
        * (hi - lo + 20)
    u = torch.rand(n, generator=gen, device=dev)
    flat = LD.voxel_index(grid, p)
    k = min(n, 64)
    u[:k] = grid.cdf[flat[:k], 0]                 # ties
    n0 = K.LAUNCHES["spatial_light_pick"]
    lid, pmf = LD.sample_light(grid, p, u)
    assert K.LAUNCHES["spatial_light_pick"] == n0 + 1
    rlid, rpmf = _plain(lambda: LD.sample_light(grid, p, u))
    assert torch.equal(lid, rlid)
    assert torch.equal(pmf.view(torch.int32), rpmf.view(torch.int32))
    q = torch.randint(-1, grid.n_lights + 1, (n,), generator=gen,
                      device=dev, dtype=torch.int32)
    out = LD.pmf_lookup(grid, p, q)
    ref = _plain(lambda: LD.pmf_lookup(grid, p, q))
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_parsed_cornell_render_matches_plain(parsed_cornell):
    """The parsed Cornell box, 1 sample through the spatial grid: K13
    launches (a pick a scatter, a lookup a non-first hit), the image
    within the golden-image tolerance of the all-plain render."""
    bundle, _ = parsed_cornell
    r = bundle.renderer()
    K.reset_launches()
    _assert_render_matches_plain(r, bundle.context(), sample_stop=1)
    assert K.LAUNCHES["spatial_light_pick"] == 4, K.LAUNCHES
    assert K.LAUNCHES["spatial_pmf_lookup"] == 4, K.LAUNCHES


@pytest.fixture(scope="module")
def quadric_scene(dev):
    """The 16-quadric table (tools/quadric_work.py) over a ground triangle,
    and 2^16 + 7 rays at it."""
    from rustracer_tpu_torch.tools.quadric_work import (quadric_rays,
                                                        quadric_table,
                                                        table_geometry)
    q = quadric_table()
    return (table_geometry(q, device=dev),
            quadric_rays(q, (1 << 16) + 7, device=dev))


def test_quadric_search_matches_plain(quadric_scene):
    from rustracer_tpu_torch.scene.tables import (intersect_quadrics_all,
                                                 quadrics_any_hit)
    geom, ray = quadric_scene
    t_max = ray.t_max.clone()
    t_max[::5] = 2.0
    n0 = dict(K.LAUNCHES)

    def closest():
        return intersect_quadrics_all(geom, ray.o, ray.d, t_max)

    def any_hit():
        return quadrics_any_hit(geom, ray.o, ray.d, t_max)
    hit, t, qid = closest()
    occ = any_hit()
    assert K.LAUNCHES["quadric_closest"] == n0["quadric_closest"] + 1
    assert K.LAUNCHES["quadric_any"] == n0["quadric_any"] + 1
    rhit, rt, rqid = _plain(closest)
    assert torch.equal(hit, rhit) and torch.equal(qid, rqid)
    assert torch.equal(occ, rhit) and torch.equal(_plain(any_hit), rhit)
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-6, atol=0)
    assert torch.isinf(t[~hit]).all() and (qid[~hit] == 0).all()
    assert 0.1 < hit.float().mean().item() < 0.9
    assert torch.unique(qid[hit]).numel() == geom.n_quadrics


def test_build_interaction_quadric_lanes_match_plain(quadric_scene):
    from rustracer_tpu_torch.scene.tables import closest_prim
    geom, ray = quadric_scene
    hit, t, prim = closest_prim(geom, ray)
    assert (hit & (prim < geom.n_quadrics)).any()

    def fn():
        return build_interaction(geom, ray, hit, t, prim)
    out, ref = fn(), _plain(fn)
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        assert not _k2_off(f, getattr(out, f), getattr(ref, f)).any(), f
    for f in ("material", "arealight", "prim_id", "valid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def _k2_held(out, ref):
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        assert not _k2_off(f, getattr(out, f), getattr(ref, f)).any(), f
    for f in ("material", "arealight", "prim_id", "valid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_build_interaction_mixed_warps_match_plain(dev):
    """K2 on warps that mix miss, triangle, sphere, cylinder and disk lanes
    (reversed quadrics among them): the 16-quadric table's hits with their
    lanes shuffled; every field within _k2_off of the plain version, the
    ids equal, and bit for bit with K2 on the lanes in their first order."""
    from rustracer_tpu_torch.ops.quadrics import CYLINDER, DISK, SPHERE
    from rustracer_tpu_torch.scene.tables import closest_prim
    from rustracer_tpu_torch.tools.quadric_work import (quadric_rays,
                                                        quadric_table,
                                                        table_geometry)
    q = quadric_table()
    geom = table_geometry(q, device=dev)
    assert geom.n_quadrics == 16 and bool(geom.q_reverse.any())
    ray = quadric_rays(q, (1 << 16) + 11, device=dev)
    hit, t, prim = closest_prim(geom, ray)
    perm = torch.randperm(hit.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    ray = type(ray)(o=ray.o[perm].contiguous(), d=ray.d[perm].contiguous(),
                    t_max=ray.t_max[perm].contiguous())
    hit, t, prim = hit[perm], t[perm], prim[perm]
    quad = hit & (prim < geom.n_quadrics)
    kinds = geom.q_type[prim[quad].long()]
    for k in (SPHERE, CYLINDER, DISK):
        assert (kinds == k).any()
    # a warp of each sort: misses, triangles and quadrics all present
    w = torch.stack([~hit, hit & ~quad, quad]).view(3, -1)[:, :2048]
    assert w.view(3, -1, 32).any(2).all(0).float().mean() > 0.5

    def fn(*a):
        return build_interaction(geom, *a)
    K.reset_launches()
    out = fn(ray, hit, t, prim)
    assert K.LAUNCHES["build_interaction"] == 1
    _k2_held(out, _plain(lambda: fn(ray, hit, t, prim)))
    inv = torch.argsort(perm)
    first = fn(type(ray)(o=ray.o[inv].contiguous(), d=ray.d[inv].contiguous(),
                         t_max=ray.t_max[inv].contiguous()),
               hit[inv], t[inv], prim[inv])
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo", "material", "arealight", "prim_id"):
        x, y = getattr(out, f), getattr(first, f)[perm]
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f


def test_testball_render_matches_plain(dev):
    """scenes/testball-matte.pbrt on the card, 1 sample: K14 (closest and
    any) and K2 launched, the image within the golden-image tolerance of
    the all-plain render."""
    import os
    from rustracer_tpu_torch.scene.api import parse_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "testball-matte.pbrt")
    bundle = parse_scene(path, device=dev).scene
    K.reset_launches()
    _assert_render_matches_plain(bundle.renderer(), bundle.context(),
                                 sample_stop=1)
    for k in K.QUADRIC_KERNELS + ("build_interaction",):
        assert K.LAUNCHES[k] > 0, K.LAUNCHES


@pytest.mark.parametrize("name", ["glass", "roughglass", "plastic",
                                  "textured", "substrate", "disney"])
def test_material_testball_render_matches_plain(dev, name):
    """A material testball on the card, 1 sample: rays leaving the glass
    ball from inside through K14 and K2, the plastic's 32-float material
    rows through K8 (Disney's 96-float rows), the textured ball through
    K5; the image within the golden-image tolerance of the all-plain
    render."""
    import os
    from rustracer_tpu_torch.scene.api import parse_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", f"testball-{name}.pbrt")
    bundle = parse_scene(path, device=dev).scene
    K.reset_launches()
    _assert_render_matches_plain(bundle.renderer(), bundle.context(),
                                 sample_stop=1)
    for k in K.QUADRIC_KERNELS + ("build_interaction", "row_gather"):
        assert K.LAUNCHES[k] > 0, K.LAUNCHES
    if name == "textured":
        assert K.LAUNCHES["atlas_lookup_ewa"] > 0, K.LAUNCHES


@pytest.fixture(scope="module")
def mixed_lights(dev):
    """tools/light_work.py's MIXED_SCENE (every light type) parsed on the
    card with the uniform pick -> its bundle."""
    import os
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.tools import light_work as LW
    sky = os.path.join(LW.SCENES, "textures", "sky.exr")
    text = LW.MIXED_SCENE.replace('"textures/sky.exr"', f'"{sky}"')
    return parse_scene_string(text, device=dev).scene


@pytest.mark.parametrize("n", [1, 1000, (1 << 18) + 3])
def test_infinite_sample_matches_plain(mixed_lights, n):
    """K15 on lanes of every row of the mixed scene (two infinite lights,
    one under a rotation): the radiance bit for bit (it depends on the
    sample's uv alone, so it pins both find_intervals), the direction,
    target and pdf within 1e-5 relative (sinf, cosf), zeros on the lanes
    of other rows."""
    from rustracer_tpu_torch.scene import lights as L
    lt, dev = mixed_lights.lights, mixed_lights.device
    g = torch.Generator(device="cpu").manual_seed(n)
    lid = torch.randint(0, lt.n_lights, (n,), generator=g).int().to(dev)
    p = (torch.rand(n, 3, generator=g) * 6 - 3).to(dev)
    u = torch.rand(n, 2, generator=g).to(dev)
    n0 = K.LAUNCHES["infinite_sample"]
    out = L.infinite_sample(lt, lid, p, u)
    assert K.LAUNCHES["infinite_sample"] == n0 + 1
    ref = _plain(lambda: L.infinite_sample(lt, lid, p, u))
    assert torch.equal(out[2], ref[2])
    for a, b in zip(out, ref):
        scale = b.abs().reshape(n, -1).max(-1).values.clamp(min=1e-30)
        assert ((a - b).abs().reshape(n, -1).max(-1).values / scale
                <= 1e-5).all()
    other = ~torch.isin(lid, torch.tensor(lt.inf_rows, device=dev,
                                          dtype=torch.int32))
    assert (out[1][other] == 0).all() and (out[2][other] == 0).all()


def _with_maps(lt, h, w, seed=5, zero_band=False):
    """``lt`` with each infinite light's map replaced by a seeded (h, w)
    map; with ``zero_band``, rows h/4 to h/2 and columns w/3 to w/2 black
    (plateaus of the cdfs: ties for the searches)."""
    from rustracer_tpu_torch.core.sampling import Distribution2D
    from rustracer_tpu_torch.scene import lights as L
    rng = np.random.default_rng(seed)
    maps = []
    for _ in lt.inf_rows:
        m = rng.random((h, w, 3)).astype(np.float32) + 0.05
        if zero_band:
            m[h // 4:h // 2] = 0.0
            m[:, w // 3:w // 2] = 0.0
        maps.append(m)
    dists = [Distribution2D.create(L.infinite_importance(m)) for m in maps]
    return dataclasses.replace(lt, **L.infinite_tensors(
        maps, dists, list(lt.inf_l2w.cpu().numpy()),
        list(lt.inf_w2l.cpu().numpy()), lt.inf_rows, lt.l_emit.cpu().numpy(),
        lt.l_emit.device))


@pytest.mark.parametrize("table", ["mixed", "96 x 192", "zero band"])
def test_infinite_sample_tables_match_plain(mixed_lights, table):
    """K15 (csrc/lights.cu, its searches in two rounds of loads) on 2^18 +
    3 lanes of every row, u at the cdfs' entries among them, over the
    mixed scene's two infinite lights (32 x 64 and 4 x 8), over 96 x 192
    maps (sides not powers of two, 97 and 193 cdf entries: a search's
    second round past the last coarse entry) and over 40 x 72 maps with
    black bands (cdf plateaus: ties): li bit for bit with the plain
    version (it pins both integer searches), wi, the target and the pdf
    within 1e-5 relative, zeros off the sky."""
    from rustracer_tpu_torch.scene import lights as L
    lt, dev = mixed_lights.lights, mixed_lights.device
    if table == "96 x 192":
        lt = _with_maps(lt, 96, 192)
    elif table == "zero band":
        lt = _with_maps(lt, 40, 72, zero_band=True)
    n = (1 << 18) + 3
    g = torch.Generator(device="cpu").manual_seed(7)
    lid = torch.randint(0, lt.n_lights, (n,), generator=g).int().to(dev)
    p = (torch.rand(n, 3, generator=g) * 6 - 3).to(dev)
    u = torch.rand(n, 2, generator=g).to(dev)
    # u exactly at cdf entries (a search's ties and ends)
    cdf = lt.inf_dists[0].marginal.cdf
    u[:cdf.numel(), 1] = cdf.to(dev)
    u[:cdf.numel(), 0] = lt.inf_dists[0].conditional.cdf[0][
        torch.arange(cdf.numel()) % lt.inf_dists[0].conditional.cdf.shape[1]
    ].to(dev)
    n0 = K.LAUNCHES["infinite_sample"]
    out = L.infinite_sample(lt, lid, p, u)
    assert K.LAUNCHES["infinite_sample"] == n0 + 1
    ref = _plain(lambda: L.infinite_sample(lt, lid, p, u))
    assert torch.equal(out[2], ref[2])
    for a, b in zip(out, ref):
        scale = b.abs().reshape(n, -1).max(-1).values.clamp(min=1e-30)
        assert ((a - b).abs().reshape(n, -1).max(-1).values / scale
                <= 1e-5).all()
    other = ~torch.isin(lid, torch.tensor(lt.inf_rows, device=dev,
                                          dtype=torch.int32))
    assert all((x[other] == 0).all() for x in out)


def test_sincos_bounded_against_sinf():
    """csrc/lights.cuh sincos_bounded (K15's and K12's lights kernel's
    sin and cos of theta and phi) against CUDA's sinf and cosf on every
    float32 in [0, 2 pi]: within 1 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rustracer_tpu_torch.tools.bench_step_kernels import sincos_check
    floats, _, _, ulp = sincos_check(log=lambda s: None)
    assert floats > 10 ** 9 and ulp <= 1


@pytest.mark.parametrize("form", ["camera", "mis uniform", "mis per lane"])
def test_infinite_escape_matches_plain(mixed_lights, form):
    """K16 on 2^18 + 5 directions (poles and the seam among them), half of
    them escaped: the radiance within 1e-5 relative plus 1e-5 / sin theta
    (acos near a pole) off the texel edges of the maps' pdfs (where an ulp
    may pick the neighbouring texel: at most 1% of the lanes), 0 on the
    other lanes."""
    from rustracer_tpu_torch.scene import lights as L
    lt, dev = mixed_lights.lights, mixed_lights.device
    n = (1 << 18) + 5
    g = torch.Generator(device="cpu").manual_seed(3)
    d = torch.randn(n, 3, generator=g)
    d[:6] = torch.tensor([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
                          [0, -1, 0], [1, 1e-7, 0]], dtype=torch.float32)
    d = d.to(dev)
    mask = (torch.rand(n, generator=g) < 0.5).to(dev)
    args = [lt, d, mask]
    if form != "camera":
        prev_pdf = (torch.rand(n, generator=g) * 3).to(dev)
        prev_spec = (torch.rand(n, generator=g) < 0.2).to(dev)
        pmfs = [0.1, 0.1] if form == "mis uniform" else \
            [torch.rand(n, generator=g).to(dev) for _ in range(2)]
        args += [prev_pdf, prev_spec, pmfs]
    n0 = K.LAUNCHES["infinite_escape"]
    out = L.infinite_escape(*args)
    assert K.LAUNCHES["infinite_escape"] == n0 + 1
    ref = _plain(lambda: L.infinite_escape(*args))
    st = torch.stack([L._inf_dir_to_uv(lt, k, d)[1]
                      for k in range(lt.n_infinite)]).min(0).values
    edge = torch.zeros_like(mask)
    for k in range(lt.n_infinite):
        h, w = lt.inf_maps[k].shape[:2]
        x = L._inf_dir_to_uv(lt, k, d)[0] * torch.tensor([w, h], device=dev)
        edge |= ((x - x.round()).abs() < 1e-4).any(-1)
    assert (edge & mask).sum() <= 0.01 * mask.sum()
    keep = mask & ~edge
    err = (out - ref).abs().max(-1).values
    bound = (1e-5 + 1e-5 / st.clamp(min=1e-12)) * ref.abs().max(-1).values
    assert (err[keep] <= bound[keep] + 1e-7).all()
    assert (out[~mask] == 0).all()


def test_grid_contrib_lights_matches_plain(mixed_lights):
    """K12's lights kernel on the mixed scene's grid (16 voxels on its
    widest axis) in one launch: each sum within 1e-5 relative of the plain
    version, 1e-6 of the column's largest (the point, cone and quadric
    branches' divides, sqrtf, sinf and cosf); on each light of
    tools/light_work.py's light_scene alone, its columns bit for bit those
    of the whole table (a block row is one light)."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    b = mixed_lights
    lt, dev = b.lights, b.device
    lo, hi = b.world_bounds
    nv, _, ext = LD.voxels(lo, hi, 16)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)
    n0 = K.LAUNCHES["spatial_grid_contrib_lights"]
    out = LD.grid_contrib(lt, lo, ext, nv, halton)
    assert K.LAUNCHES["spatial_grid_contrib_lights"] == n0 + 1
    ref = _plain(lambda: LD.grid_contrib(lt, lo, ext, nv, halton))
    top = ref.abs().max(0).values
    assert ((out - ref).abs() <= torch.maximum(1e-5 * ref.abs(),
                                               1e-6 * top)).all()
    import os
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.tools import light_work as LW
    sky = os.path.join(LW.SCENES, "textures", "sky.exr")
    rows = {"point": [0], "distant": [1], "full sphere (cone)": [2],
            "clipped sphere": [3], "disk": [4], "cylinder": [5],
            "triangle": [6, 7], "infinite": [8], "infinite ones": [9]}
    for name, js in rows.items():
        one = parse_scene_string(LW.light_scene(name).replace(
            '"textures/sky.exr"', f'"{sky}"'), device=dev).scene.lights
        n0 = K.LAUNCHES["spatial_grid_contrib_lights"]
        col = LD.grid_contrib_lights(one, lo, ext, nv, halton)
        assert K.LAUNCHES["spatial_grid_contrib_lights"] == n0 + 1
        assert torch.equal(col, out[:, js]), name


@pytest.mark.parametrize("scene", ["cornell-box", "light_scene triangle"])
def test_grid_contrib_lights_takes_triangle_tables(dev, scene):
    """A table of triangle lights alone (scenes/cornell-box.pbrt's, and
    tools/light_work.py's triangle light) through the lights kernel
    (grid_contrib_lights) and the triangle kernel (grid_contrib): the same
    code for a triangle row, so the same bits; grid_contrib launches the
    triangle kernel only."""
    import os
    from rustracer_tpu_torch.scene import lightdistrib as LD
    from rustracer_tpu_torch.scene.api import parse_scene, parse_scene_string
    from rustracer_tpu_torch.tools import light_work as LW
    if scene == "cornell-box":
        b = parse_scene(os.path.join(os.path.dirname(LW.SCENES), "scenes",
                                     "cornell-box.pbrt"), device=dev).scene
    else:
        b = parse_scene_string(LW.light_scene("triangle"), device=dev).scene
    lt = b.lights
    assert lt.kinds == {"tri"}
    lo, hi = b.world_bounds
    nv, _, ext = LD.voxels(lo, hi, 16)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)
    K.reset_launches()
    tri = LD.grid_contrib(lt, lo, ext, nv, halton)
    assert K.LAUNCHES["spatial_grid_contrib"] == 1
    assert K.LAUNCHES["spatial_grid_contrib_lights"] == 0
    assert torch.equal(LD.grid_contrib_lights(lt, lo, ext, nv, halton), tri)


def test_grid_contrib_lights_columns_keep_the_in_order_sum(mixed_lights):
    """K12's lights kernel on the mixed scene's grid (16 voxels on its
    widest axis): the full sphere's (the cone), the distant light's and
    both infinite lights' columns bit for bit with the design that summed
    the 128 probes in order in each thread. Each probe's contribution is
    the kernel's own on a one-probe table (a block computes a probe alone
    as it computes it among 128), each within 1e-5 relative (or 1e-6 of
    the column's largest) of the plain version's probe contribution
    (scene/lightdistrib.py _probe_contrib); the in-order float32 sum of
    the 128 then equals the column in every bit. The distant light's
    probes are the plain version's bits too, and so is their sum."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    b = mixed_lights
    lt, dev = b.lights, b.device
    lo, hi = b.world_bounds
    nv, _, ext = LD.voxels(lo, hi, 16)
    halton = torch.as_tensor(LD._radical_inverse_table(LD.N_SAMPLES),
                             device=dev)
    rows = {"full sphere (cone)": 2, "distant": 1, "infinite": 8,
            "infinite ones": 9}
    assert bool(lt.l_cone[2]) and int(lt.l_type[1]) == 1
    assert [int(lt.l_type[j]) for j in (8, 9)] == [3, 3]
    out = LD.grid_contrib_lights(lt, lo, ext, nv, halton)
    probes = torch.stack([
        LD.grid_contrib_lights(lt, lo, ext, nv,
                               halton[s:s + 1].contiguous())
        for s in range(LD.N_SAMPLES)])          # (S, V, n_lights)
    v = int(np.prod(nv))
    corners = LD.voxel_corners(lo, ext, nv, 0, v, dev)
    pts = corners[None] + halton[:, None, :3] * torch.as_tensor(ext,
                                                                device=dev)
    for name, j in rows.items():
        ref = _plain(lambda: LD._probe_contrib(lt, j, pts, halton[:, 3:5]))
        mine = probes[:, :, j]
        top = ref.abs().max()
        assert ((mine - ref).abs() <= torch.maximum(1e-5 * ref.abs(),
                                                    1e-6 * top)).all(), name
        acc = torch.zeros_like(mine[0])
        for s in range(LD.N_SAMPLES):
            acc = acc + mine[s]
        assert torch.equal(acc, out[:, j]), name
        if name == "distant":
            assert torch.equal(mine, ref)
            acc = torch.zeros_like(ref[0])
            for s in range(LD.N_SAMPLES):
                acc = acc + ref[s]
            assert torch.equal(acc, out[:, j])


@pytest.mark.parametrize("form", ["camera", "mis"])
def test_infinite_escape_wraps_the_seam_and_poles(mixed_lights, form):
    """K16 over maps whose sides are not powers of two (23 x 37 and 23 x
    37, seeded) under identity transforms, on directions on the seam (u =
    0: atan2 of +0; u = 1: atan2 of a negative tiny y, phi rounding to 2
    pi) at 64 polar angles, at both poles (v = 0 and v = 1: the lookup's
    rows -1 and h) and on seeded directions: the texels are the floor
    modulo's. The radiance within 1e-5 relative of the plain version's
    (scene/lights.py bilerp_level, REPEAT) where the direction is exact,
    and at the poles and the seam's ends equal to the lookup done here in
    float64 from those texels."""
    from rustracer_tpu_torch.core.sampling import Distribution2D
    from rustracer_tpu_torch.scene import lights as L
    lt, dev = mixed_lights.lights, mixed_lights.device
    h, w = 23, 37
    rng = np.random.default_rng(23)
    maps = [rng.random((h, w, 3)).astype(np.float32) + 0.05
            for _ in lt.inf_rows]
    dists = [Distribution2D.create(L.infinite_importance(m)) for m in maps]
    eye = [np.eye(4, dtype=np.float32) for _ in lt.inf_rows]
    lt = dataclasses.replace(lt, **L.infinite_tensors(
        maps, dists, eye, eye, lt.inf_rows, lt.l_emit.cpu().numpy(),
        lt.l_emit.device))
    theta = torch.linspace(0.0, float(np.pi), 64)
    st, ct = torch.sin(theta), torch.cos(theta)
    z = torch.zeros_like(theta)
    seam0 = torch.stack([st, z, ct], -1)                # u = 0
    seam1 = torch.stack([st, torch.full_like(z, -1e-30), ct], -1)  # u = 1
    poles = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                          [1.0, 0.0, 0.0], [1.0, -1e-30, 0.0],
                          [-1.0, 0.0, 0.0]])
    g = torch.Generator(device="cpu").manual_seed(29)
    d = torch.cat([poles, seam0, seam1,
                   torch.randn(4096, 3, generator=g)]).to(dev)
    n = d.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    args = [lt, d, mask]
    if form == "mis":
        args += [(torch.rand(n, generator=g) * 3).to(dev),
                 (torch.rand(n, generator=g) < 0.2).to(dev), [0.1, 0.1]]
    out = L.infinite_escape(*args)
    ref = _plain(lambda: L.infinite_escape(*args))
    uv, st = _plain(lambda: [torch.stack(x) for x in zip(*[
        L._inf_dir_to_uv(lt, k, d) for k in range(lt.n_infinite)])])
    st = st.min(0).values
    # the map pdf's texel may flip on an ulp of uv (the MIS form) where
    # uv * side sits on an integer other than the exact ends
    x = uv * torch.tensor([w, h], device=dev)
    edge = (((x - x.round()).abs() < 1e-4) & (x != 0)
            & (x != torch.tensor([w, h], device=dev))).any(-1).any(0)
    keep = ~edge if form == "mis" else torch.ones_like(edge)
    assert edge.sum() <= 0.01 * n
    err = (out - ref).abs().max(-1).values
    scale = ref.abs().max(-1).values
    bound = (1e-5 + 1e-5 / st.clamp(min=1e-12)) * scale + 1e-7
    hand = torch.zeros(n, dtype=torch.bool, device=dev)
    hand[:poles.shape[0]] = True
    assert (err[hand] <= 1e-5 * scale[hand]).all()
    assert (err[keep] <= bound[keep]).all()
    assert torch.isfinite(out).all() and (out > 0).all()
    # the poles and the seam's ends by hand: uv, then the floor modulo's
    # texels (the camera form: each light's Le summed)
    if form == "camera":
        for i in range(poles.shape[0]):
            want = np.zeros(3)
            for k in range(lt.n_infinite):
                s = float(uv[k, i, 0]) * w - 0.5
                t = float(uv[k, i, 1]) * h - 0.5
                s0, t0 = int(np.floor(s)), int(np.floor(t))
                ds, dt = s - s0, t - t0
                m = maps[k].astype(np.float64)
                val = sum(wt * m[tt % h, ss % w] for wt, ss, tt in (
                    ((1 - ds) * (1 - dt), s0, t0), (ds * (1 - dt), s0 + 1, t0),
                    ((1 - ds) * dt, s0, t0 + 1), (ds * dt, s0 + 1, t0 + 1)))
                want += val * lt.inf_scale[k].cpu().numpy()
            got = out[i].cpu().numpy().astype(np.float64)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), i


@pytest.mark.parametrize("name", ["veach-mis", "envmap-dof"])
def test_light_scene_render_matches_plain(dev, name):
    """veach-mis (sphere lights: the cone, K12's lights kernel in the
    parse) and envmap-dof (the sky: K15, K16) on the card, 1 sample, the
    image within the golden-image tolerance of the all-plain render."""
    import os
    from rustracer_tpu_torch.scene.api import parse_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", f"{name}.pbrt")
    K.reset_launches()
    bundle = parse_scene(path, device=dev).scene
    if name == "veach-mis":
        assert K.LAUNCHES["spatial_grid_contrib_lights"] == 1
    K.reset_launches()
    _assert_render_matches_plain(bundle.renderer(), bundle.context(),
                                 sample_stop=1)
    need = ("quadric_closest",) + (("infinite_sample", "infinite_escape")
                                   if name == "envmap-dof" else ())
    for k in need:
        assert K.LAUNCHES[k] > 0, K.LAUNCHES


def test_device_ms_says_how_it_timed(dev, monkeypatch):
    """device_ms times K8 by the profiler's records; where three traces
    hold none, kernel_ms raises NoDeviceRecords and device_ms times the
    call by CUDA events and says "queued" (cold too), and a call that
    launches no kernel of the port is refused, not timed."""
    from rustracer_tpu_torch.tools import timing
    tab = torch.rand(4096, 128, device=dev)
    idx = torch.randint(0, 4096, (1 << 16,), device=dev, dtype=torch.int32)
    ms, by = timing.device_ms(lambda: row_gather(tab, idx), 5,
                              "row_gather_kernel")
    assert by == "profiler" and 0.0 < ms < 25.0
    monkeypatch.setattr(timing, "_device_events", lambda prof: [])
    with pytest.raises(timing.NoDeviceRecords, match="saw none"):
        timing.kernel_ms(lambda: row_gather(tab, idx), 5,
                         "row_gather_kernel")
    for cold in (False, True):
        with pytest.warns(RuntimeWarning, match="CUDA events"):
            ms, by = timing.device_ms(lambda: row_gather(tab, idx), 5,
                                      "row_gather_kernel", cold=cold)
        assert by == "queued" and 0.0 < ms < 25.0
    x = torch.zeros(1 << 20, device=dev)
    with pytest.raises(AssertionError, match="launches no kernel"):
        timing.device_ms(lambda: x.add_(1.0), 5, "no_such_kernel")


# --- the rest of shading: K17 (the per-texture lookups), K18 (noise), K19
# (the Fourier BSDF) ---

def _held_to_plain(fn, args, out):
    """``out`` of K17-K19's entry point ``fn`` on ``args`` against its
    plain version: tools/texture_work.py compare_with_plain (every lane
    within its tolerance, but for the rare lanes whose discrete choice a
    last-bit difference flipped, each held to the plain version at the
    other choice)."""
    from rustracer_tpu_torch.tools.texture_work import compare_with_plain
    return compare_with_plain(fn.__name__, args, out)


@pytest.mark.parametrize("layout", ["flat", "quad"])
@pytest.mark.parametrize("wrap", [WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP])
def test_mipmap_lookup_matches_plain(dev, wrap, layout):
    """K17 in each mode on a non-power-of-two image (flat (T, 3) and quad
    (T, 12) texel rows), 2^16 lanes of footprints of anisotropy 1 to 32:
    within 1e-5 absolute on every lane (the exact mode 2e-5: expf near the
    ellipse's edge; a lane whose rounded level flipped, at most 1e-4 of
    them, within that of the neighbouring level's plain value)."""
    from rustracer_tpu_torch.ops import mipmap as MM
    rs = np.random.RandomState(wrap)
    img = rs.rand(37, 50, 3).astype(np.float32)
    pyr = [torch.from_numpy(lv).to(dev) for lv in build_pyramid(img)]
    tx = MM.pyramid_texels(pyr)
    if layout == "quad":
        tx = MM.Texels(A.atlas_quad_texels([pyr]), tx.meta, 3)
    n = 1 << 16
    st = torch.from_numpy(rs.uniform(-0.5, 1.5, (n, 2)).astype(
        np.float32)).to(dev)
    ang = rs.uniform(0, 2 * np.pi, n)
    minor = 10 ** rs.uniform(-3.5, -0.5, n)
    major = minor * 10 ** rs.uniform(0, np.log10(32.0), n)
    d0 = torch.from_numpy(np.stack([np.cos(ang) * major, np.sin(ang) * major],
                                   -1).astype(np.float32)).to(dev)
    d1 = torch.from_numpy(np.stack([-np.sin(ang) * minor, np.cos(ang) * minor],
                                   -1).astype(np.float32)).to(dev)
    width = torch.from_numpy((10 ** rs.uniform(-4, 0.5, n)).astype(
        np.float32)).to(dev)
    calls = [(MM.lookup_trilinear, (tx, st, width, wrap)),
             (MM.lookup_ewa, (tx, st, d0, d1, 4.0, wrap)),
             (MM.lookup_ewa, (tx, st, d0, d1, 8.0, wrap)),
             (MM.lookup_ewa_exact, (tx, st, d0, d1, 16.0, wrap)),
             (MM.lookup_ewa_exact, (tx, st, d0, d1, 32.0, wrap))]
    for fn, args in calls:
        K.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        assert K.LAUNCHES["mipmap_lookup"] == 1
        _held_to_plain(fn, args, out)


@pytest.mark.parametrize("layout", ["flat", "quad"])
@pytest.mark.parametrize("wrap", [WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP])
def test_mipmap_exact_at_the_tap_cap_matches_plain(dev, wrap, layout):
    """K17's exact mode where the footprints' bounding boxes reach past
    the 128 taps the reference visits (anisotropy 32 at the clamp, boxes
    of hundreds of texels, so a lane walks 128 taps in 2 x 2 blocks, the
    last block cut at the cap): within 2e-5 absolute of the plain version
    on every lane
    (a lane whose rounded level flipped, at most 1e-4 of them, within that
    of the neighbouring level's plain value)."""
    from rustracer_tpu_torch.ops import mipmap as MM
    rs = np.random.RandomState(10 + wrap)
    img = rs.rand(64, 48, 3).astype(np.float32)
    pyr = [torch.from_numpy(lv).to(dev) for lv in build_pyramid(img)]
    tx = MM.pyramid_texels(pyr)
    if layout == "quad":
        tx = MM.Texels(A.atlas_quad_texels([pyr]), tx.meta, 3)
    n = 1 << 14
    st = torch.from_numpy(rs.uniform(-0.5, 1.5, (n, 2)).astype(
        np.float32)).to(dev)
    ang = rs.uniform(0, 2 * np.pi, n)
    minor = 10 ** rs.uniform(-2.5, -1.0, n)
    major = minor * 32.0
    d0 = torch.from_numpy(np.stack([np.cos(ang) * major, np.sin(ang) * major],
                                   -1).astype(np.float32)).to(dev)
    d1 = torch.from_numpy(np.stack([-np.sin(ang) * minor, np.cos(ang) * minor],
                                   -1).astype(np.float32)).to(dev)
    args = (tx, st, d0, d1, 32.0, wrap)
    capped = (MM.ellipse(tx, st, d0, d1, 32.0).n_box >= MM.N_TAPS_EXACT)
    assert float(capped.float().mean()) > 0.8
    K.reset_launches()
    out = MM.lookup_ewa_exact(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["mipmap_lookup"] == 1
    _held_to_plain(MM.lookup_ewa_exact, args, out)


@pytest.mark.parametrize("layout", ["flat", "quad"])
@pytest.mark.parametrize("wrap", [WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP])
def test_mipmap_bwd_matches_plain(dev, wrap, layout):
    """K20, the texel gradient of K17's lookups, in each mode on a
    non-power-of-two image's (T, 3) rows, 2^16 lanes of footprints of
    anisotropy 1 to 32 and a seeded gradient of both signs: every texel's
    gradient within 1e-5 of the largest sum of its terms' magnitudes
    (tools/texture_work.py compare_bwd_with_plain: atomic adds in another
    order; an exact lane whose rounded level can flip held apart), one
    launch a call. "quad": the forward a train step runs, K17 on the
    (T, 3) rows, equals K17 on the quad rows a render of a scene whose
    atlas wraps REPEAT reads, bit for bit."""
    from rustracer_tpu_torch.ops import mipmap as MM
    from rustracer_tpu_torch.tools.texture_work import compare_bwd_with_plain
    rs = np.random.RandomState(10 + wrap)
    img = rs.rand(37, 50, 3).astype(np.float32)
    pyr = [torch.from_numpy(lv).to(dev) for lv in build_pyramid(img)]
    tx = MM.pyramid_texels(pyr)
    quad = tx._replace(texels=A.atlas_quad_texels([pyr]))
    n = 1 << 16

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    st = t(rs.uniform(-0.5, 1.5, (n, 2)))
    ang = rs.uniform(0, 2 * np.pi, n)
    minor = 10 ** rs.uniform(-3.5, -0.5, n)
    major = minor * 10 ** rs.uniform(0, np.log10(32.0), n)
    d0 = t(np.stack([np.cos(ang) * major, np.sin(ang) * major], -1))
    d1 = t(np.stack([-np.sin(ang) * minor, np.cos(ang) * minor], -1))
    width = t(10 ** rs.uniform(-4, 0.5, n))
    g = t(rs.uniform(-1, 1, (n, 3)))
    for mode, ma in ((MM.TRILINEAR, 8.0), (MM.EWA, 4.0), (MM.EWA, 8.0),
                     (MM.EWA_EXACT, 16.0), (MM.EWA_EXACT, 32.0)):
        args = (tx, mode, wrap, st, d0, d1, width, ma)
        if layout == "quad" and wrap == WRAP_REPEAT:
            fwd = [MM._lookup(x, mode, wrap, st, d0, d1, width, ma)
                   for x in (tx, quad)]
            assert torch.equal(fwd[0], fwd[1])
        K.reset_launches()
        out = MM.mipmap_lookup_bwd(g, *args)
        torch.cuda.synchronize()
        assert K.LAUNCHES["mipmap_lookup_bwd"] == 1
        compare_bwd_with_plain(g, *args, out)


def _k20_case(dev, case, wrap):
    """K20's inputs for ``case`` on a 37 x 50 image's (T, 3) rows, 2^14 + 5
    lanes: "contended" every lane at one point with footprints that pick
    the coarsest level (every add on its one texel; a quarter of the lanes
    with a zero gradient), "scattered" seeded points and footprints of
    anisotropy 1 to 32, 70% of the lanes with a zero gradient (the lanes
    of other surfaces) and a few with a non-finite st (their zero
    gradient still adds NaN, as the plain version's does) -> (g, tx, st,
    d0, d1, width)."""
    from rustracer_tpu_torch.ops import mipmap as MM
    rs = np.random.RandomState(20 + wrap)
    img = rs.rand(37, 50, 3).astype(np.float32)
    tx = MM.pyramid_texels([torch.from_numpy(lv).to(dev)
                            for lv in build_pyramid(img)])
    n = (1 << 14) + 5

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    g = rs.uniform(-1, 1, (n, 3))
    if case == "contended":
        st = np.tile([[0.37, 0.61]], (n, 1))
        d0 = np.tile([[3.0, 0.5]], (n, 1))
        d1 = np.tile([[-0.5, 2.0]], (n, 1))
        width = np.full(n, 8.0)
        g[rs.uniform(size=n) < 0.25] = 0.0
    else:
        st = rs.uniform(-0.5, 1.5, (n, 2))
        ang = rs.uniform(0, 2 * np.pi, n)
        minor = 10 ** rs.uniform(-3.5, -0.5, n)
        major = minor * 10 ** rs.uniform(0, np.log10(32.0), n)
        d0 = np.stack([np.cos(ang) * major, np.sin(ang) * major], -1)
        d1 = np.stack([-np.sin(ang) * minor, np.cos(ang) * minor], -1)
        width = 10 ** rs.uniform(-4, 0.5, n)
        g[rs.uniform(size=n) < 0.7] = 0.0
    return t(g), tx, t(st), t(d0), t(d1), t(width)


# (mode, threads a lookup): each block's choice (0) and each G forced,
# every route the mode has (csrc/mipmap_bwd.cu has_route)
_K20_ROUTES = [(mode, group) for mode, groups in
               ((0, (0, 1, 2)), (1, (0, 4, 8)), (2, (0, 1, 2, 4, 8)))
               for group in groups]


@pytest.mark.parametrize("case", ["contended", "scattered"])
@pytest.mark.parametrize("wrap", [WRAP_REPEAT, WRAP_BLACK, WRAP_CLAMP])
@pytest.mark.parametrize("mode,group", _K20_ROUTES)
def test_mipmap_bwd_routes_match_plain(dev, mode, group, wrap, case):
    """Each route of K20 (its threads a lookup: each block's choice (0) or
    each one forced) in each mode and wrap, on a contended and a scattered
    case (_k20_case): within 1e-5 of the largest sum of its terms'
    magnitudes (compare_bwd_with_plain), one launch. The scattered case's
    non-finite lanes leave NaN where the plain version does."""
    from rustracer_tpu_torch.ops import mipmap as MM
    from rustracer_tpu_torch.tools.texture_work import compare_bwd_with_plain
    g, tx, st, d0, d1, width = _k20_case(dev, case, wrap)
    ma = 8.0 if mode == MM.EWA else 16.0
    args = (tx, mode, wrap, st, d0, d1, width, ma)
    K.reset_launches()
    out = MM._k20(g, *args, group=group)
    torch.cuda.synchronize()
    assert K.LAUNCHES["mipmap_lookup_bwd"] == 1
    compare_bwd_with_plain(g, *args, out)
    if case == "scattered":
        st = st.clone()
        st[::997] = float("nan")
        g = torch.where(torch.isnan(st[:, :1]), 0.0, g)
        args = (tx, mode, wrap, st, d0, d1, width, ma)
        out = MM._k20(g, *args, group=group)
        with K.plain_reference():
            ref = MM.mipmap_lookup_bwd(g, *args)
        assert torch.equal(torch.isnan(out), torch.isnan(ref))


def test_mipmap_bwd_refuses_a_route_it_has_not(dev):
    """K20 takes 1 or 2 threads a trilinear lookup, 4 or 8 an 8-tap one
    and 1 to 8 an exact one, a power of two (csrc/mipmap_bwd.cu
    has_route); others raise."""
    from rustracer_tpu_torch.ops import mipmap as MM
    g, tx, st, d0, d1, width = _k20_case(dev, "scattered", WRAP_REPEAT)
    for mode, refused in ((0, (4, 3, -1)), (1, (1, 2, 16, 3)),
                          (2, (16, 3, 6))):
        for group in refused:
            with pytest.raises(RuntimeError, match="failed to launch"):
                MM._k20(g, tx, mode, WRAP_REPEAT, st, d0, d1, width, 8.0,
                        group=group)


def test_mipmap_lookup_trains_through_k20(dev):
    """A lookup of texel rows that require grad runs as the autograd
    Function: K17 forward, K20 backward, the gradient reaching the levels
    (a 1-channel image through its replication to 3) as the all-plain
    path's within 1e-5 of the sums."""
    from rustracer_tpu_torch.ops import mipmap as MM
    rs = np.random.RandomState(3)
    n = 1 << 14
    st = torch.from_numpy(rs.rand(n, 2).astype(np.float32)).to(dev)
    width = torch.from_numpy(rs.uniform(1e-3, 0.1, n).astype(
        np.float32)).to(dev)
    grads = []
    for plain in (False, True):
        levels = [torch.from_numpy(lv).to(dev).requires_grad_()
                  for lv in build_pyramid(rs.rand(32, 32, 1))]
        K.reset_launches()
        with K.plain_reference() if plain else contextlib.nullcontext():
            out = MM.lookup_trilinear(MM.pyramid_texels(levels), st, width)
            out.sum().backward()
        torch.cuda.synchronize()
        assert K.LAUNCHES["mipmap_lookup_bwd"] == (0 if plain else 1)
        assert out.shape == (n, 1)
        grads.append(torch.cat([lv.grad.reshape(-1) for lv in levels]))
    top = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * top


@pytest.mark.parametrize("name", ["textures-image", "plastic-cornell"])
def test_gradient_through_a_sampled_direction_is_refused(dev, name,
                                                         tmp_path):
    """One 16^2 train step on the card of textures-image (its ball's image
    bump map) and of the plastic Cornell box (a glossy lobe's roughness):
    their bounce directions depend on a trained leaf, and the step raises
    naming ROADMAP item B12 before any kernel is handed a tensor that
    requires grad."""
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.tools import texture_work as TW
    text = TW.plastic_cornell_text(16) if name == "plastic-cornell" else \
        TW.scene_text(name, res=16, spp=1, bsdf_dir=str(tmp_path))
    pb = parse_scene_string(text, device=dev).scene
    step = make_train_step(pb.integrator.li, pb.camera, pb.film, pb.sampler,
                           lr=1.0, device=dev)
    with pytest.raises(NotImplementedError,
                       match="sampled ray direction.*B12"):
        step(pb.context(), torch.zeros(16, 16, 3, device=dev))


@pytest.mark.parametrize("turbulence", [False, True])
def test_noise_matches_plain(dev, turbulence):
    """K18 (fbm, turbulence) on 2^18 seeded points and footprints over six
    decades: within 1e-5 absolute on every lane (a lane whose octave count
    log2f flipped at an integer, at most 1e-4 of them, within that of the
    plain value on the other side of it)."""
    from rustracer_tpu_torch.core import noise as NZ
    rs = np.random.RandomState(3)
    n = 1 << 18
    p = torch.from_numpy(rs.uniform(-40, 40, (n, 3)).astype(np.float32))
    scale = 10 ** rs.uniform(-5, 1, (n, 1))
    dx = torch.from_numpy((rs.normal(size=(n, 3)) * scale).astype(np.float32))
    dy = torch.from_numpy((rs.normal(size=(n, 3)) * scale).astype(np.float32))
    p, dx, dy = p.to(dev), dx.to(dev), dy.to(dev)
    fn = NZ.turbulence if turbulence else NZ.fbm
    for omega, octaves in ((0.5, 8), (0.6, 5), (0.5, 3)):
        K.reset_launches()
        out = fn(p, dx, dy, omega, octaves)
        torch.cuda.synchronize()
        assert K.LAUNCHES["noise_fbm"] == 1
        _held_to_plain(fn, (p, dx, dy, omega, octaves), out)


def _fourier_tables(which):
    """K19's table sets by the path their m_pad takes (csrc/fourier.cu):
    ``cap8`` (m_pad 8: the 8-order registers), ``cap8+1`` (m_pad 9, just
    above: f and pdf in 32-order chunks, sample_f the shared-memory
    slice), ``mixed`` (tests/test_torch_fourier.py's: a Lambertian, a
    multi-order 3-channel and a 1-channel table, m_pad 11), ``wide`` (64
    knots, orders up to 64: two chunks) and ``long`` (orders 994-1000:
    past the slice, the rest summed where taken) -> (tables, lanes)."""
    from rustracer_tpu_torch.ops import fourier as FO
    from rustracer_tpu_torch.tools.fourier_precision import long_table
    from rustracer_tpu_torch.tools.texture_work import fourier_table
    if which == "mixed":
        t3 = fourier_table(n_mu=20, m_max=11, seed=9)
        t3["n_channels"] = 1
        return [FO.make_lambertian_table((0.6, 0.4, 0.2), n_mu=12),
                fourier_table(transmission=0.1, eta=1.5), t3], 1 << 16
    return {"cap8": ([fourier_table()], 1 << 16),
            "cap8+1": ([fourier_table(m_max=9, seed=2)], 1 << 16),
            "wide": ([fourier_table(n_mu=64, m_max=64)], 1 << 16),
            "long": ([long_table()], 1 << 13)}[which]


@pytest.mark.parametrize("which", ["mixed", "cap8", "cap8+1", "wide",
                                   "long"])
def test_fourier_matches_plain(dev, which):
    """K19 (f, pdf, sample_f) on a table set of each path
    (``_fourier_tables``), a third of the lanes masked off: f and pdf
    within 1e-5 of the largest magnitude plus 1e-6 on every lane; the
    sampled direction within 1e-4, and its f and pdf as f and pdf, on
    every lane but those whose bisections' or Newton steps' compares
    flipped (at most 1e-4 of them: a unit direction, its f within 1e-3 of
    the plain f there, a finite pdf >= 0); zeros off the mask."""
    from rustracer_tpu_torch.ops import fourier as FO
    tabs, n = _fourier_tables(which)
    ts = FO.make_table_set(tabs).to(dev)
    rs = np.random.RandomState(7)

    def dirs():
        v = rs.normal(size=(n, 3))
        return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True))
                                .astype(np.float32)).to(dev)
    tid = torch.from_numpy(rs.randint(0, len(tabs), n).astype(
        np.int32)).to(dev)
    wo, wi = dirs(), dirs()
    u = torch.from_numpy(rs.uniform(size=(n, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.arange(n) % 3 != 0).to(dev)
    for fn, second in ((FO.fourier_f, wi), (FO.fourier_pdf, wi),
                       (FO.fourier_sample_f, u)):
        K.reset_launches()
        out = fn(ts, tid, wo, second, mask)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fourier_bsdf"] == 1
        _held_to_plain(fn, (ts, tid, wo, second, mask), out)
        for a in (out if isinstance(out, tuple) else (out,)):
            assert bool((a[~mask] == 0).all())


@pytest.mark.parametrize("name", ["textures-procedural", "textures-image",
                                  "testball-fourier"])
def test_texture_scene_render_matches_plain(dev, name, tmp_path):
    """tools/texture_work.py's scenes at 64^2, 2 samples: launching K17
    (textures-image), K18 (textures-procedural) or K19 (testball-fourier),
    the image within the golden-image tolerance of the all-plain render."""
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.tools.texture_work import scene_text
    bundle = parse_scene_string(scene_text(name, res=64, spp=2,
                                           bsdf_dir=str(tmp_path)),
                                device=dev).scene
    K.reset_launches()
    _assert_render_matches_plain(bundle.renderer(), bundle.context(),
                                 sample_stop=2)
    need = {"textures-procedural": "noise_fbm",
            "textures-image": "mipmap_lookup",
            "testball-fourier": "fourier_bsdf"}[name]
    assert K.LAUNCHES[need] > 0, K.LAUNCHES


def _instanced_soup(dev, n_obj=60, n_static=25, n_inst=7, seed=3,
                    flip=False, alpha=False):
    """tests/test_instancing.py's scene built by the port: a static soup,
    then one object soup (scaled by 0.3) placed by n_inst seeded affine
    transforms (a mirror on half of them where ``flip``), through
    build_wide_scene; with ``alpha``, uv on every triangle and a 4 x 4
    checkerboard alpha map on half of them, a shadow-alpha map of zeros on
    a quarter. -> GeometryTables on ``dev``."""
    rng = np.random.default_rng(seed)
    static = random_soup(n_static, seed=seed + 1) if n_static else None
    obj = random_soup(n_obj, seed=seed + 2)
    xforms = []
    for _ in range(n_inst):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        s = rng.uniform(0.4, 1.6, 3)
        if flip and rng.random() < 0.5:
            s[0] = -s[0]
        m = np.eye(4)
        m[:3, :3] = r @ np.diag(s)
        m[:3, 3] = rng.uniform(-4, 4, 3)
        xforms.append(m.astype(np.float32))
    sv = static["tv_p"] if static else np.zeros((0, 3), np.float32)
    v = np.concatenate([sv, obj["tv_p"] * 0.3]).astype(np.float32)
    tris = _soup_dict(v)
    nt = len(tris["t_idx"])
    bvh = bvh_build.build_wide_scene(
        tris, [(len(sv) // 3, nt)],
        [dict(obj=0, o2w=m, w2o=np.linalg.inv(m),
              flip=bool(np.linalg.det(m[:3, :3]) < 0)) for m in xforms])
    kw = {}
    if alpha:
        tris["tv_uv"] = rng.uniform(-0.5, 1.5, (len(v), 2)).astype(np.float32)
        tris["t_has_uv"] = np.arange(nt) % 5 != 0
        tris["t_alpha_tex"] = np.where(np.arange(nt) % 2 == 0, 0, -1) \
            .astype(np.int32)
        tris["t_shadow_alpha_tex"] = np.where(np.arange(nt) % 4 == 1, 1, -1) \
            .astype(np.int32)
        m0 = (np.add.outer(np.arange(4), np.arange(4)) % 2).astype(np.float32)
        kw["alpha"] = dict(
            alpha_atlas=np.concatenate([m0.ravel(), np.zeros(16, np.float32)]),
            alpha_meta=np.array([[0, 4, 4], [16, 4, 4]], np.int32))
    return make_geometry(tris, bvh=bvh, device=dev, **kw)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["instanced", "instanced flip",
                                  "no static", "one instance", "alpha",
                                  "instanced alpha"])
def test_traverse16_geometry_matches_plain(dev, case, any_hit):
    """K1's instanced, alpha and instanced-alpha walks: hit, t bits, prim,
    instance and the counts bit for bit with the plain walk, on 16384
    random rays (every 7th dead), of which some hundreds hit."""
    kw = {"instanced": {}, "instanced flip": dict(flip=True),
          "no static": dict(n_static=0, n_inst=5, seed=40),
          "one instance": dict(n_inst=1, seed=30),
          "alpha": dict(n_inst=0, alpha=True),
          "instanced alpha": dict(flip=True, alpha=True)}[case]
    if case == "alpha":
        tris = random_soup(400, seed=8)
        nt = 400
        rng = np.random.default_rng(9)
        tris["tv_uv"] = rng.uniform(-0.5, 1.5, (3 * nt, 2)).astype(np.float32)
        tris["t_has_uv"] = np.arange(nt) % 5 != 0
        tris["t_alpha_tex"] = np.where(np.arange(nt) % 2 == 0, 0, -1) \
            .astype(np.int32)
        tris["t_shadow_alpha_tex"] = np.where(np.arange(nt) % 4 == 1, 1, -1) \
            .astype(np.int32)
        m0 = (np.add.outer(np.arange(4), np.arange(4)) % 2).astype(np.float32)
        g = make_geometry(tris, device=dev, alpha=dict(
            alpha_atlas=np.concatenate([m0.ravel(), np.zeros(16, np.float32)]),
            alpha_meta=np.array([[0, 4, 4], [16, 4, 4]], np.int32)))
    else:
        g = _instanced_soup(dev, **kw)
    assert g.has_instances == (case != "alpha")
    assert g.has_alpha == ("alpha" in case)
    o, d = random_rays(16384, seed=5)
    t_max = np.where(np.arange(16384) % 7 == 0, 0.0, np.inf)
    o, d, t_max = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in (o, d, t_max))
    from rustracer_tpu_torch.accel.traverse16 import k1_entry
    name = k1_entry(g, any_hit)

    def fn():
        return traverse16(g, o, d, t_max, any_hit=any_hit, with_counts=True,
                          with_inst=True)
    n0 = K.LAUNCHES[name]
    h, t, p, i, c = fn()
    assert K.LAUNCHES[name] == n0 + 1
    rh, rt, rp, ri, rc = _plain(fn)
    assert torch.equal(h, rh) and torch.equal(p, rp) and torch.equal(c, rc)
    assert torch.equal(i, ri)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert h.sum() > 50
    if g.has_instances and not any_hit:
        assert (i[h] >= 0).any()


@pytest.mark.parametrize("flip", [False, True])
def test_build_interaction_instances_matches_plain(dev, flip):
    """K2's instance branch (build_interaction_inst) on the closest hits of
    an instanced soup, static and instanced lanes: each field within 1e-5
    absolute or relative (p_error relative) of the plain version."""
    from rustracer_tpu_torch.core.ray import Ray
    from rustracer_tpu_torch.scene.tables import closest_prim
    g = _instanced_soup(dev, flip=flip, seed=12)
    o, d = random_rays(16384, seed=13)
    ray = Ray(o=torch.as_tensor(o, device=dev), d=torch.as_tensor(d,
                                                                  device=dev),
              t_max=torch.full((16384,), float("inf"), device=dev))
    hit, t, prim, inst = closest_prim(g, ray, with_inst=True)
    assert (inst[hit] >= 0).any() and (inst[hit] < 0).any()

    def fn():
        return build_interaction(g, ray, hit, t, prim, inst)
    n0 = K.LAUNCHES["build_interaction_inst"]
    out, ref = fn(), _plain(fn)
    assert K.LAUNCHES["build_interaction_inst"] == n0 + 1
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        assert not _k2_off(f, getattr(out, f), getattr(ref, f)).any(), f
    for f in ("material", "arealight", "prim_id", "valid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


@pytest.mark.parametrize("name", ["alpha-cards", "alpha-cards-static",
                                  "gallery"])
def test_geometry_scene_render_matches_plain(dev, name, tmp_path):
    """tools/geometry_work.py's scenes at 64^2, 2 samples, and the
    instanced gallery (subdivision 3, a 3 x 3 grid) at 64 x 48: the
    image within the golden-image tolerance of the all-plain render, the
    scene's K1 walk and (instanced) K2's instance branch launched."""
    from rustracer_tpu_torch.scene.api import parse_scene_string
    from rustracer_tpu_torch.scenes import build_instanced
    from rustracer_tpu_torch.tools.geometry_work import scene_text
    if name == "gallery":
        ctx, cam, film, sampler, integ = build_instanced(
            subdiv=3, res=(64, 48), spp=2, grid=3, device=dev)
        renderer = Renderer(integ.li, cam, film, sampler,
                            RenderConfig(max_lanes=4096), device=dev)
    else:
        bundle = parse_scene_string(scene_text(name, res=64, spp=2,
                                               tex_dir=str(tmp_path)),
                                    device=dev).scene
        renderer, ctx = bundle.renderer(), bundle.context()
    K.reset_launches()
    _assert_render_matches_plain(renderer, ctx, sample_stop=2)
    inst = ctx.geom.has_instances
    kind = "_".join(k for k, on in (("inst", inst),
                                    ("alpha", ctx.geom.has_alpha)) if on)
    for q in ("closest", "any"):
        assert K.LAUNCHES[f"traverse16_{kind}_{q}"] > 0, K.LAUNCHES
    assert (K.LAUNCHES["build_interaction_inst"] > 0) == inst, K.LAUNCHES


# ---------------------------------------------------------------------------
# the path chain for Lambertian surfaces under triangle lights (K21-K23)
# ---------------------------------------------------------------------------

def _path_case(dev, geometry, parsed_cornell, case, monkeypatch):
    """-> (renderer, ctx, tile) of a recorded step: the textured dragon at
    full width (its 4096-lane tile) and with the slab tiers opened to
    1024-lane tiles (tile 0, the top rows, mostly sky: its interior
    bounces on a B/4 slab), the parsed Cornell box (its grid pick) and
    the gallery."""
    from rustracer_tpu_torch.scenes import build_instanced
    lanes = 4096
    if case == "gallery":
        ctx, cam, film, sampler, integ = build_instanced(
            subdiv=3, res=(64, 48), spp=2, grid=3, device=dev)
    elif case == "cornell":
        bundle, _ = parsed_cornell
        r = bundle.renderer()
        return r, bundle.context(), r.tiles[0]
    else:
        if case == "textured slab":
            monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 1024)
            lanes = 1024
        ctx, cam, film, sampler, integ, _ = build_dragon(
            sub=4, res=(64, 64), device=dev, geometry=geometry)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=lanes),
                 device=dev)
    return r, ctx, r.tiles[0]


@pytest.mark.parametrize("case", ["textured", "textured slab", "cornell",
                                  "gallery"])
def test_path_kernels_match_twins(dev, geometry, parsed_cornell, case,
                                  monkeypatch):
    """K21, K22 and K23 on every call of a recorded step against their
    plain twins on the same inputs: every output bit for bit (the same
    float operations; rsqrtf is torch.rsqrt's function on the card, the
    concentric map's cosf and sinf their fast path), bool and int fields
    equal; a slab step's calls run on its B/2 or B/4 lanes."""
    from rustracer_tpu_torch.tools.pathshade_work import (NAMES,
                                                          capture_path_step,
                                                          compare_with_twin)
    r, ctx, tile = _path_case(dev, geometry, parsed_cornell, case,
                              monkeypatch)
    P.reset_tiers()
    calls = capture_path_step(r, ctx, tile)
    assert [len(calls[n]) for n in NAMES] == [5, 4, 4], calls.keys()
    if case == "textured slab":
        assert P.TIERS[2] + P.TIERS[4] == 1, P.TIERS
        assert calls["path_nee_add"][-1][0].shape[0] < tile[0].shape[0]
    for name in NAMES:
        for args in calls[name]:
            n0 = K.LAUNCHES[name]
            res = compare_with_twin(name, args)
            assert K.LAUNCHES[name] == n0 + 1
            bad = {f: v for f, v in res.items() if v["differ"]}
            assert not bad, (name, bad)


@pytest.mark.parametrize("case", ["textured slab", "cornell", "gallery"])
def test_path_route_render_runs_no_twin(dev, geometry, parsed_cornell, case,
                                        monkeypatch):
    """A render on the card takes K21-K23 on every bounce and launches no
    plain twin; its image within the golden-image tolerance of the
    all-plain render."""
    from rustracer_tpu_torch.ops import pathshade as PS
    r, ctx, _ = _path_case(dev, geometry, parsed_cornell, case, monkeypatch)
    ran = []
    for name in ("path_hit_emit_plain", "path_scatter_lambert_plain",
                 "path_nee_add_plain"):
        orig = getattr(PS, name)

        def watched(*a, _name=name, _orig=orig, **k):
            if not K._plain[0]:
                ran.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(PS, name, watched)
    K.reset_launches()
    _assert_render_matches_plain(r, ctx, sample_stop=1)
    assert not ran, ran
    assert min(K.LAUNCHES[k] for k in K.PATH_KERNELS) > 0, K.LAUNCHES


def test_path_kernels_refuse_what_they_do_not_take(dev, parsed_cornell):
    """K22 refuses more than one lobe a lane and a light table with other
    than triangle lights; every wrapper refuses an input that requires
    grad, naming ROADMAP item B1.1."""
    from rustracer_tpu_torch.ops import pathshade as PS
    from rustracer_tpu_torch.tools.pathshade_work import capture_path_step
    bundle, _ = parsed_cornell
    r = bundle.renderer()
    calls = capture_path_step(r, bundle.context(), r.tiles[0])
    args = list(calls["path_scatter_lambert"][0])
    lt, lobes = args[0], args[2]
    wide = lobes._replace(params=lobes.params.repeat(1, 2, 1),
                          active=lobes.active.repeat(1, 2))
    with pytest.raises(ValueError, match="lobes.params"):
        PS.path_scatter_lambert(*(args[:2] + [wide] + args[3:]))
    other = dataclasses.replace(lt, kinds=frozenset({"tri", "point"}))
    with pytest.raises(ValueError, match="triangle lights only"):
        PS.path_scatter_lambert(*([other] + args[1:]))
    st = args[3]
    grad = dataclasses.replace(st, beta=st.beta.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="item B1.1"):
        PS.path_scatter_lambert(*(args[:3] + [grad] + args[4:]))
