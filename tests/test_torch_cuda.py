"""The hand kernels of the port against their plain PyTorch versions, on a
CUDA device (the kernels have no CPU mode). Every test here skips without a
card. On the GPU machine, where JAX is absent, run them without the JAX
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: sampler bit-equal; traversal hit/prim equal and t bit-equal
(the same float operations in the same order); interaction fields within
1e-5 absolute or relative (rsqrt rounds differently); film within 1e-5
relative (atomic adds in no fixed order); a small render within the
golden-image tolerance of tests/test_golden.py (mean 2e-3, p99 2e-2)."""
import numpy as np
import pytest
import torch

from rustracer_tpu_torch import cuda as K
from rustracer_tpu_torch.accel.traverse16 import traverse16
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scene.tables import build_interaction
from rustracer_tpu_torch.scenes import build_dragon_matte

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    dev = torch.device("cuda:0")
    ctx, cam, film, sampler, integ, _ = build_dragon_matte(
        sub=4, res=(64, 64), spp=2, device=dev)
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=4096),
                 device=dev)
    px, py, v = r.tiles[0]
    pix = py.long() * 64 + px.long()
    smp = torch.full_like(pix, 1)
    p_film = torch.stack([px, py], -1).float() + sampler.get_2d(pix, smp, 0)
    ray = cam.generate_ray_differential(p_film)
    return dict(ctx=ctx, film=film, sampler=sampler, renderer=r, pix=pix,
                smp=smp, p_film=p_film, ray=ray, valid=v)


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


def test_render_matches_plain(scene):
    ctx, r = scene["ctx"], scene["renderer"]
    K.reset_launches()
    img = r.film.to_image(r.render_state(ctx)).cpu().numpy()
    assert all(v > 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    with K.plain_reference():
        ref = r.film.to_image(r.render_state(ctx)).cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-4
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    assert err.mean() / scale <= 2e-3
    assert np.percentile(err, 99) / scale <= 2e-2
