"""Port parity of the alive-first compaction (ops/compact.py and the slab
tiers of integrators/path.py).

Tolerances: the alive-first order, its rank and the alive count are
bit-equal with the reference's ``jnp.argsort(~alive)``, ``argsort(order)``
and sum; take then put restores every field exactly. A compacted run
matches the port's own full-width run within rtol 2e-5, atol 2e-6 (the
reference's own bound for compaction, tests/test_path_compact.py: the slab
shapes change float rounding, not the estimator), and the JAX compacted run
lane for lane within the tolerance of tests/test_torch_path.py (1e-4
relative, 1e-5 absolute on at least 99% of the lanes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.integrators import path as JP
from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu.render.sampler import DimAllocator as JaxDims
from rustracer_tpu_torch.integrators import path as TP
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.render.renderer import Lanes
from rustracer_tpu_torch.render.sampler import DimAllocator

from test_torch_textured import RES, jax_dragon_textured, port_from_jax

torch.set_num_threads(1)

B = 4096


def _mask(kind):
    rs = np.random.RandomState(5)
    if kind == "all alive":
        return np.ones(B, bool)
    if kind == "all dead":
        return np.zeros(B, bool)
    if kind in ("half", "quarter"):
        m = np.zeros(B, bool)
        m[rs.permutation(B)[:B // (2 if kind == "half" else 4)]] = True
        return m
    return rs.rand(B) < float(kind)


@pytest.mark.parametrize("kind", ["all alive", "all dead", "half", "quarter",
                                  "0.3", "0.7"])
def test_alive_first_order_bit_equal(kind):
    alive = _mask(kind)
    order, rank, n_alive = C.alive_first_order(torch.as_tensor(alive))
    jorder = jnp.argsort(~jnp.asarray(alive))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(rank.numpy(),
                                  np.asarray(jnp.argsort(jorder)))
    assert order.dtype == rank.dtype == n_alive.dtype == torch.int32
    assert int(n_alive) == int(alive.sum())


def test_take_then_put_restores_state():
    rs = np.random.RandomState(2)
    alive = torch.as_tensor(rs.rand(B) < 0.3)
    fields = [torch.as_tensor(rs.rand(B, 3).astype(np.float32)),
              torch.as_tensor(rs.rand(B).astype(np.float32)),
              torch.as_tensor(rs.rand(B) < 0.5),
              torch.as_tensor(rs.randint(0, 1 << 32, B, dtype=np.int64))]
    order, _, n_alive = C.alive_first_order(alive)
    for w in (B // 2, B // 4, B):
        subs = C.slab_take(fields, order, w)
        for f, s in zip(fields, subs):
            assert torch.equal(s, f[order[:w].long()])
        if w >= int(n_alive):
            assert bool(subs[2][:int(n_alive)].eq(
                fields[2][alive]).all())
        back = C.slab_put([torch.zeros_like(f) for f in fields], subs,
                          order, w)
        kept = torch.zeros(B, dtype=torch.bool)
        kept[order[:w].long()] = True
        for f, b in zip(fields, back):
            assert torch.equal(b[kept], f[kept])
            assert not b[~kept].any()


def _camera_lanes(jcam, jsampler, pix, xy):
    """The spp=64 config's camera rays of pixels ``pix`` in both packages."""
    lanes = JaxLanes(pixel_idx=jnp.asarray(pix),
                     sample_idx=jnp.zeros(len(pix), jnp.uint32))
    p_film, p_lens, _ = jsampler.get_camera_sample(
        jnp.asarray(xy), lanes.pixel_idx, lanes.sample_idx)
    ray = jcam.generate_ray_differential(p_film, p_lens)
    return lanes, ray.scaled_differentials(1.0 / np.sqrt(jsampler.spp))


@pytest.fixture(scope="module")
def scene():
    jctx, jcam, _, jsampler, jinteg = jax_dragon_textured(res=RES)
    ys, xs = np.mgrid[0:RES[1], 0:RES[0]]
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    pix = (py.astype(np.int64) * RES[0] + px).astype(np.uint32)
    xy = np.stack([px, py], -1).astype(np.float32)
    lanes, ray = _camera_lanes(jcam, jsampler, pix, xy)
    from rustracer_tpu.scene.tables import scene_intersect
    hit = np.asarray(scene_intersect(jctx.geom, ray).valid)
    return dict(jax=(jctx, jcam, jsampler, jinteg), pix=pix, xy=xy, hit=hit)


def _lane_set(scene, n_hit, n):
    """n lanes of which n_hit are camera hits (seeded choice)."""
    rs = np.random.RandomState(9)
    hit = np.flatnonzero(scene["hit"])
    miss = np.flatnonzero(~scene["hit"])
    sel = np.concatenate([rs.choice(hit, n_hit, replace=False),
                          rs.choice(miss, n - n_hit, replace=False)])
    sel = rs.permutation(sel)
    return scene["pix"][sel], scene["xy"][sel]


@pytest.mark.parametrize("tier,n_hit", [(2, 110), (4, 50)])
def test_compacted_run_matches(scene, monkeypatch, tier, n_hit):
    """256 lanes with n_hit camera hits: after bounce 0 at most half (or a
    quarter) of the lanes live, so with PATH_COMPACT_MIN_B at 256 the
    interior bounces run on the B/2 (or B/4) slab."""
    jctx, jcam, jsampler, jinteg = scene["jax"]
    pix, xy = _lane_set(scene, n_hit, 256)
    ctx, cam, sampler, integ = port_from_jax(jctx, jcam, jsampler, jinteg)

    def port_li(integ):
        lanes = Lanes(pixel_idx=torch.as_tensor(pix.astype(np.int64)),
                      sample_idx=torch.zeros(len(pix), dtype=torch.int64))
        p_film, _, _ = sampler.get_camera_sample(
            torch.as_tensor(xy), lanes.pixel_idx, lanes.sample_idx)
        ray = cam.generate_ray_differential(p_film).scaled_differentials(
            1.0 / np.sqrt(sampler.spp))
        return integ._run(ctx, ray, lanes, sampler, DimAllocator()).numpy()

    monkeypatch.setattr(TP, "PATH_COMPACT_MIN_B", 256)
    TP.reset_tiers()
    out_c = port_li(integ)
    assert TP.TIERS == {1: 0, 2: int(tier == 2), 4: int(tier == 4)}
    out_f = port_li(dataclasses.replace(integ, compact_interior=False))
    np.testing.assert_allclose(out_c, out_f, rtol=2e-5, atol=2e-6)
    assert (out_c.sum(-1) > 0).sum() > n_hit // 2     # lit lanes

    monkeypatch.setattr(JP, "PATH_COMPACT_MIN_B", 256)
    jinteg_c = dataclasses.replace(jinteg, compact_interior=True)

    @jax.jit
    def jax_li(pixel_idx, pixel_xy):
        lanes, ray = _camera_lanes(jcam, jsampler, pixel_idx, pixel_xy)
        return jinteg_c._run(jctx, ray, lanes, jsampler, JaxDims())[0]

    ref = np.asarray(jax_li(jnp.asarray(pix), jnp.asarray(xy)))
    close = np.all(np.abs(out_c - ref) <= 1e-5 + 1e-4 * np.abs(ref), axis=-1)
    print(f"diverging lanes: {int((~close).sum())} of {len(close)}")
    assert close.mean() >= 0.99


@pytest.mark.parametrize("w", [B // 2, B // 4])
def test_take_put_vjp_matches_jax(w):
    """The slab moves' autograd Functions (K7 forward, K7 as its own
    transpose backward, their plain versions here) against the reference's
    ``perm_take`` / ``perm_put`` custom_vjps (tests/test_path_compact.py
    TestPermTakePutVJP's function): value and both gradients within 1e-6
    relative."""
    rs = np.random.RandomState(3)
    x = rs.rand(B, 3).astype(np.float32)
    full = rs.rand(B, 3).astype(np.float32)
    alive = rs.rand(B) < 0.4
    order = jnp.argsort(~jnp.asarray(alive))
    sel, rank = order[:w], jnp.argsort(order)

    def f_jax(x, full):
        sub = JP.perm_take(x, sel, rank)
        out = JP.perm_put(full, sub * 2.0, sel, rank)
        return jnp.sum(out ** 2) + jnp.sum(sub ** 3)

    v_ref, (gx_ref, gf_ref) = jax.value_and_grad(f_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(full))
    torder, _, _ = C.alive_first_order(torch.as_tensor(alive))
    tx = torch.tensor(x, requires_grad=True)
    tfull = torch.tensor(full, requires_grad=True)
    flag = torch.as_tensor(alive)     # rides along without a gradient
    sub, sub_flag = C.slab_take([tx, flag], torder, w)
    out, out_flag = C.slab_put([tfull.clone(), flag.clone()],
                               [sub * 2.0, sub_flag], torder, w)
    assert sub_flag.grad_fn is None and out_flag.grad_fn is None
    v = (out ** 2).sum() + (sub ** 3).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_ref),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tfull.grad.numpy(), np.asarray(gf_ref),
                               rtol=1e-6, atol=1e-7)
