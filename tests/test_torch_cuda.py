"""The hand kernels of the port against their plain PyTorch versions, on a
CUDA device (the kernels have no CPU mode). Every test here skips without a
card. On the GPU machine, where JAX is absent, run them without the JAX
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: sampler bit-equal; traversal hit/prim equal and t bit-equal
(the same float operations in the same order); interaction fields within
1e-5 absolute or relative (rsqrt rounds differently); film within 1e-5
relative (atomic adds in no fixed order); atlas EWA within 1e-5 absolute on
at least 99.9% of the lanes (the plain version divides by the weight sum
as a multiply by its reciprocal on the card, the kernel divides; a lane
whose mip level sits on an integer may floor to the other level); the
alive-first order, the slab moves and the row gather bit-equal; small
renders within the golden-image tolerance of tests/test_golden.py (mean
2e-3, p99 2e-2)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rustracer_tpu_torch import cuda as K
from rustracer_tpu_torch.accel.traverse16 import traverse16
from rustracer_tpu_torch.core.interaction import compute_differentials
from rustracer_tpu_torch.integrators import path as P
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.ops.gather import row_gather
from rustracer_tpu_torch.ops.mipmap import (WRAP_BLACK, WRAP_CLAMP,
                                            WRAP_REPEAT, build_pyramid)
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scene import atlas as A
from rustracer_tpu_torch.scene.tables import build_interaction, scene_intersect
from rustracer_tpu_torch.scenes import (build_dragon, build_dragon_matte,
                                        dragon_geometry)

pytestmark = pytest.mark.cuda

MATTE_KERNELS = ("sample_1d", "sample_2d", "traverse16_closest",
                 "traverse16_any", "build_interaction_tri", "film_add_samples",
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
def test_traverse16_matches_plain(scene, any_hit):
    g, ray = scene["ctx"].geom, scene["ray"]

    def fn():
        return traverse16(g, ray.o, ray.d, ray.t_max, any_hit=any_hit,
                          with_counts=True)
    h, t, p, c = fn()
    rh, rt, rp, rc = _plain(fn)
    assert torch.equal(h, rh) and torch.equal(p, rp) and torch.equal(c, rc)
    assert torch.equal(t, rt)
    assert h.float().mean() > 0.3


def test_build_interaction_matches_plain(scene):
    g, ray = scene["ctx"].geom, scene["ray"]
    hit, t, tid = traverse16(g, ray.o, ray.d, ray.t_max, any_hit=False)
    prim = torch.where(hit, tid + g.n_quadrics, 0)

    def fn():
        return build_interaction(g, ray, hit, t, prim)
    out, ref = fn(), _plain(fn)
    for f in ("p", "p_error", "n", "uv", "dpdu", "dpdv", "ns", "ss", "ts",
              "dndu", "dndv", "wo"):
        a, b = getattr(out, f), getattr(ref, f)
        d = (a - b).abs()
        assert not ((d > 1e-5) & (d > 1e-5 * b.abs())).any(), f
    for f in ("material", "arealight", "prim_id", "valid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


def test_film_matches_plain(scene):
    film, p_film, v = scene["film"], scene["p_film"], scene["valid"]
    rad = torch.rand((p_film.shape[0], 3), device=p_film.device)

    def fn():
        return film.add_samples(film.init_state(p_film.device), p_film, rad,
                                valid=v)
    out, ref = fn(), _plain(fn)
    torch.testing.assert_close(out.rgb, ref.rgb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out.wsum, ref.wsum, rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_bad_input(scene):
    g, ray = scene["ctx"].geom, scene["ray"]
    with pytest.raises(ValueError):
        traverse16(g, ray.o[:, :2], ray.d, ray.t_max, any_hit=False)
    with pytest.raises(ValueError):
        traverse16(g, ray.o.double(), ray.d, ray.t_max, any_hit=False)


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


def _ewa_inputs(dev, wrap, n=1 << 14):
    """Three small pyramids, four registrations of wrap mode ``wrap``, and n
    lanes with uv in [-0.5, 1.5], random differentials on 3/4 of them and
    zeros on the rest, reg = -1 on some."""
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
    diffs = torch.as_tensor((scale * sign * (rs.rand(n, 1) < 0.75))
                            .astype(np.float32), device=dev)
    si = SimpleNamespace(
        uv=torch.as_tensor(rs.uniform(-0.5, 1.5, (n, 2)).astype(np.float32),
                           device=dev),
        dudx=diffs[:, 0].contiguous(), dvdx=diffs[:, 1].contiguous(),
        dudy=diffs[:, 2].contiguous(), dvdy=diffs[:, 3].contiguous())
    reg = torch.as_tensor(rs.randint(-1, 4, n).astype(np.int32), device=dev)
    timg = [[torch.as_tensor(lv) for lv in p] for p in images]
    return (timg, torch.as_tensor(meta["atlas_meta"], device=dev),
            torch.as_tensor(meta["atlas_levels"], device=dev), regs, reg, si)


def _ewa_close(out, ref, reg):
    bad = ((out - ref).abs().max(-1).values > 1e-5).float().mean().item()
    assert bad <= 1e-3, bad
    assert torch.equal(out[reg < 0], torch.zeros_like(out[reg < 0]))


@pytest.mark.parametrize("quad,wrap", [(True, WRAP_REPEAT),
                                       (False, WRAP_REPEAT),
                                       (False, WRAP_BLACK),
                                       (False, WRAP_CLAMP)])
def test_atlas_ewa_matches_plain(dev, quad, wrap):
    timg, meta, levels, regs, reg, si = _ewa_inputs(dev, wrap)
    texels = (A.atlas_quad_texels if quad else A.atlas_texels)(timg).to(dev)
    n0 = K.LAUNCHES["atlas_lookup_ewa"]

    def fn():
        return A.atlas_lookup_ewa(texels, meta, levels, regs, reg, si,
                                  quad=quad)
    out, ref = fn(), _plain(fn)
    assert K.LAUNCHES["atlas_lookup_ewa"] == n0 + 1
    _ewa_close(out, ref, reg)
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


@pytest.mark.parametrize("n", [1, 1000, (1 << 18) + 123])
def test_alive_first_order_bit_equal(dev, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    for frac in (0.0, 0.25, 0.5, 0.9, 1.0):
        alive = torch.rand(n, generator=gen, device=dev) < frac
        out = C.alive_first_order(alive)
        ref = _plain(lambda: C.alive_first_order(alive))
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b)


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


def test_textured_render_matches_plain(textured, monkeypatch):
    """The 64^2 textured dragon, 1 sample, with the slab tiers opened to
    its 4096-lane tile: every kernel launches, a slab tier runs."""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 1024)
    t = textured
    r = Renderer(t["integ"].li, t["cam"], t["film"], t["sampler"],
                 RenderConfig(max_lanes=1024), device=t["si"].t.device)
    K.reset_launches()
    P.reset_tiers()
    _assert_render_matches_plain(r, t["ctx"], sample_stop=1)
    assert all(v > 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert P.TIERS[2] + P.TIERS[4] > 0, P.TIERS
