"""Port parity of the sharded train step: ``rustracer_tpu_torch.parallel.
mesh`` make_sharded_train_step on gloo ranks of the CPU against the JAX
package's on a 2 x 2 mesh of its virtual CPU devices, and against the
port's one-device make_train_step where one rank's lanes do not reach a
leaf; a Fourier scene is refused (ROADMAP B11b).

The JAX parity: the 16^2 Cornell box with atlas imagemap walls (test
``test_torch_mesh.jax_scene``), 2 spp (samples 0 and 1, one a sample
rank), depth 3, a seeded numpy target, lr 1 (a float32 leaf moves by at
most an ulp of the difference, so the implied gradient (old - new) / lr
resolves 1e-7). Bounds: loss rtol 2e-5, implied gradients rtol 3e-4,
atol 1e-7 (tests/test_mesh.py:140-144).

The unreached leaf: the Cornell box at 16^2, 1 spp, depth 2 (textures
are looked up at camera hits only) with the red wall an atlas imagemap,
on a 2 x 1 mesh: rank 0 takes the pixels whose camera ray misses the
wall, rank 1 those that hit it (each block padded with invalid lanes);
then rank 0 takes only padding (it renders nothing, so every leaf's
gradient there is None and joins the reduction as zeros). Each equals
make_train_step's step over the same pixels and sample within the bounds
above (the sums' order differs). Rank 0's pixels alone leave the wall's
texels as they were. At world size 1 the sharded step is make_train_step's
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh import jax_scene
from rustracer_tpu_torch.parallel.launch import init_rank, spawn
from rustracer_tpu_torch.parallel.mesh import (float_leaves, make_device_mesh,
                                               make_sharded_train_step,
                                               make_train_step, sample_lanes)
from rustracer_tpu_torch.parallel.ranks import mesh_job
from rustracer_tpu_torch.render.renderer import Lanes, RenderConfig
from rustracer_tpu_torch.scene.tables import scene_intersect
from rustracer_tpu_torch.scenes import build_cornell

torch.set_num_threads(1)

RES = (16, 16)
LR = 1.0
WALL = dict(res=RES, spp=1, max_depth=2, imagemap_walls=(1,))


def target(seed=7):
    return np.random.default_rng(seed).uniform(
        0.0, 0.5, RES[::-1] + (3,)).astype(np.float32)


def implied(old, new):
    return [(np.asarray(o, np.float64) - np.asarray(n, np.float64)) / LR
            for o, n in zip(old, new)]


def check_grads(old, new, ref_new):
    for g, r in zip(implied(old, new), implied(old, ref_new)):
        np.testing.assert_allclose(g, r, rtol=3e-4, atol=1e-7)
    assert max(np.abs(g).max() for g in implied(old, ref_new)) > 1e-6


def same_on_every_rank(out, i):
    for rank in out[1:]:
        assert rank[i]["train"]["loss"] == out[0][i]["train"]["loss"]
        for a, b in zip(rank[i]["train"]["leaves"],
                        out[0][i]["train"]["leaves"]):
            assert torch.equal(a, b)


def test_sharded_train_step_matches_jax():
    from rustracer_tpu.parallel.mesh import (make_device_mesh as jax_mesh,
                                             make_sharded_train_step as jtrain)
    tgt = target()
    task = dict(build=build_cornell,
                kw=dict(res=RES, spp=2, max_depth=3, imagemap_walls=(1, 2)),
                train=dict(shape=(2, 2), target=tgt, lr=LR))
    out = spawn(mesh_job, 4, [task], device="cpu", timeout=120)
    same_on_every_rank(out, 0)
    port = out[0][0]["train"]

    ctx, cam, film, sampler, integ = jax_scene((1, 2))
    mesh = jax_mesh(data=2, sample=2, devices=jax.devices()[:4])
    px, py, valid = sample_lanes(build_cornell(**task["kw"],
                                               device="cpu")[2], 2)
    new_ctx, loss = jtrain(integ.li, cam, film, sampler, mesh, lr=LR)(
        ctx, jnp.asarray(tgt), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(valid), jnp.uint32(0))
    floats = [x for x in jax.tree.leaves(ctx.textures)
              if jnp.issubdtype(x.dtype, jnp.floating)]
    new = [x for x in jax.tree.leaves(new_ctx.textures)
           if jnp.issubdtype(x.dtype, jnp.floating)]
    assert len(port["leaves"]) == len(floats)
    print(f"loss port {port['loss']:.8g}, JAX {float(loss):.8g}")
    assert port["loss"] == pytest.approx(float(loss), rel=2e-5)
    check_grads(floats, [p.numpy() for p in port["leaves"]], new)


def wall_lanes():
    """-> (pixels missing the red wall, pixels hitting it) at sample 0, as
    (px, py) numpy pairs."""
    ctx, cam, film, sampler, _ = build_cornell(**WALL, device="cpu")
    px, py, _ = sample_lanes(film)
    tx, ty = torch.as_tensor(px), torch.as_tensor(py)
    pix = ty.long() * RES[0] + tx.long()
    lanes = Lanes(pixel_idx=pix, sample_idx=torch.zeros_like(pix))
    p_film, _, _ = sampler.get_camera_sample(torch.stack([tx, ty], -1).float(),
                                             lanes.pixel_idx,
                                             lanes.sample_idx)
    si = scene_intersect(ctx.geom, cam.generate_ray_differential(p_film))
    wall = (si.valid & (si.material == 1)).numpy()
    assert 0 < wall.sum() < wall.size
    return (px[~wall], py[~wall]), (px[wall], py[wall])


def blocks(*parts):
    """Rank blocks of equal length: each (px, py) part padded with invalid
    lanes (None: padding only) -> (px, py, valid)."""
    n = max(len(p[0]) for p in parts if p is not None)
    out = [[], [], []]
    for p in parts:
        px, py = p if p is not None else (np.zeros(0, np.int32),) * 2
        pad = n - len(px)
        out[0].append(np.concatenate([px, np.zeros(pad, np.int32)]))
        out[1].append(np.concatenate([py, np.zeros(pad, np.int32)]))
        out[2].append(np.arange(n) < len(px))
    return tuple(np.concatenate(o) for o in out)


def test_a_leaf_one_rank_does_not_reach():
    miss, hit = wall_lanes()
    tgt = target(8)
    cases = {"wall on rank 1 only": blocks(miss, hit),
             "rank 0 padding only": blocks(None, (np.concatenate(
                 [miss[0], hit[0]]), np.concatenate([miss[1], hit[1]]))),
             "rank 0's lanes alone": blocks(miss, None)}
    tasks = [dict(build=build_cornell, kw=WALL,
                  train=dict(shape=(2, 1), target=tgt, lr=LR, lanes=lanes))
             for lanes in cases.values()]
    out = spawn(mesh_job, 2, tasks, device="cpu", timeout=120)
    for i in range(len(tasks)):
        same_on_every_rank(out, i)

    ctx, cam, film, sampler, integ = build_cornell(**WALL, device="cpu")
    old, _ = float_leaves(ctx.textures)
    step = make_train_step(integ.li, cam, film, sampler, lr=LR,
                           config=RenderConfig(max_lanes=1 << 16),
                           device="cpu")
    new, loss = step(ctx, torch.as_tensor(tgt), 0)
    ref, _ = float_leaves(new.textures)
    for i in range(2):
        res = out[0][i]["train"]
        assert res["loss"] == pytest.approx(float(loss), rel=2e-5)
        check_grads(old, [p.numpy() for p in res["leaves"]], ref)
    # rank 0 rendered nothing: every leaf None there; on rank 1 only the
    # red wall's constant albedo (an imagemap serves the wall)
    assert out[0][1]["train"]["unreached"] == len(old)
    assert out[1][1]["train"]["unreached"] == 1
    # rank 0's pixels alone leave the wall's texels as they were
    alone = out[0][2]["train"]["leaves"]
    images = ctx.textures["images"][0]
    moved = [not torch.equal(a, b) for a, b in zip(old, alone)]
    assert any(moved)
    for lv in images:
        k = next(j for j, p in enumerate(old) if p is lv)
        assert not moved[k]


def test_fourier_is_refused(tmp_path):
    """make_sharded_train_step refuses a Fourier BSDF (K19 has no backward:
    ROADMAP B11b) when it is built, before any collective."""
    from rustracer_tpu_torch.integrators.path import PathIntegrator
    from rustracer_tpu_torch.scene.materials import (FourierMaterial,
                                                     MaterialSet)
    ctx, cam, film, sampler, _ = build_cornell(res=(8, 8), spp=1,
                                               device="cpu")
    integ = PathIntegrator(mat_set=MaterialSet([FourierMaterial(0)]),
                           max_depth=2)
    init_rank(0, 1, f"file://{tmp_path}/rendezvous", device="cpu",
              timeout=60)
    try:
        mesh = make_device_mesh(device="cpu")
        with pytest.raises(NotImplementedError, match="B11b"):
            make_sharded_train_step(integ.li, cam, film, sampler, mesh)
    finally:
        torch.distributed.destroy_process_group()


def test_world_size_one_equals_make_train_step(tmp_path):
    """At world size 1 the sharded step over the film's lanes in the
    renderer's tiles is make_train_step's, bit for bit."""
    ctx, cam, film, sampler, integ = build_cornell(**WALL, device="cpu")
    config = RenderConfig(max_lanes=100)
    tgt = torch.as_tensor(target(9))
    new, loss = make_train_step(integ.li, cam, film, sampler, lr=LR,
                                config=config, device="cpu")(ctx, tgt, 0)
    init_rank(0, 1, f"file://{tmp_path}/rendezvous", device="cpu",
              timeout=60)
    try:
        train = make_sharded_train_step(
            integ.li, cam, film, sampler, make_device_mesh(device="cpu"),
            lr=LR, config=config)
        new_s, loss_s = train(ctx, tgt, *sample_lanes(film, 100))
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(loss, loss_s)
    for a, b in zip(float_leaves(new.textures)[0],
                    float_leaves(new_s.textures)[0]):
        assert torch.equal(a, b)
