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
all-plain render."""
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
from rustracer_tpu_torch.render.sampler import DimAllocator
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


def _chain_binary(lo, hi, max_prims):
    """A binary tree in the SAH builder's layout that is a chain: interior
    2s holds leaf 2s+1 (triangle s) and the interior 2s+2 (the rest)."""
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
    assert all(K.LAUNCHES[k] > 0 for k in K.BACKWARD_KERNELS), K.LAUNCHES
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
