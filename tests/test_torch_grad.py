"""Port parity of the gradient path: texture gradients of the port's
renders against ``jax.grad`` of the JAX package's, against the port's own
central finite differences, compacted against full width, and the
one-device train step (``parallel/mesh.py`` make_train_step) against the
JAX ``make_sharded_train_step`` on a 1 x 1 mesh.

Setups: tests/test_grad.py's (the 16^2 Cornell box, 4 spp, depth 3, the
loss the mean radiance over pixels and samples; the white walls' kd0, or
their 4x4 atlas imagemap's level 0); the train steps on the 16^2 Cornell
with atlas imagemap walls, 1 sample a step, depth 3.

Bounds: port against JAX, ||g_port - g_jax|| / ||g_jax|| <= 1e-3 and every
element within 1e-2 max |g_jax| (float sums in other orders through a
path of three bounces; the observed errors are printed); against finite
differences rel 2e-2 (tests/test_grad.py:117); compacted against full
width rtol 2e-5, atol 1e-7 (tests/test_path_compact.py); train steps:
losses and updated leaves within 1e-4 relative, gradients within the JAX
bound above."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grad import RES, SPP, _make_loss, _setup
from rustracer_tpu_torch import convert
from rustracer_tpu_torch import cuda as K
from rustracer_tpu_torch.integrators import path as TP
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.parallel.mesh import (float_leaves, grad_errors,
                                               make_train_step)
from rustracer_tpu_torch.render.renderer import (Lanes, RenderConfig,
                                                 RenderContext,
                                                 scrub_radiance)
from rustracer_tpu_torch.render.sampler import DimAllocator
from rustracer_tpu_torch.scenes import build_dragon, cornell_box

torch.set_num_threads(1)


def _port(jctx, jcam, jsampler, jinteg):
    """The port's scene of a test_grad setup: its own Cornell tables, the
    JAX materials and textures carried over with grad on the float
    leaves."""
    from rustracer_tpu_torch.integrators.path import PathIntegrator
    geom, lights = cornell_box(device="cpu")
    ctx = RenderContext(geom=geom, lights=lights,
                        textures=convert.textures_from_jax(
                            jctx.textures, device="cpu",
                            requires_grad=True))
    return (ctx, convert.camera_from_jax(jcam),
            convert.sampler_from_jax(jsampler),
            PathIntegrator(mat_set=convert.material_set_from_jax(
                jinteg.mat_set), max_depth=jinteg.max_depth))


def _port_loss(ctx, cam, sampler, integ):
    """test_grad.py's loss on the port: mean radiance over all pixels and
    SPP samples (no differential scaling, as there)."""
    ys, xs = np.mgrid[0:RES[1], 0:RES[0]]
    px = torch.as_tensor(xs.ravel().astype(np.int32))
    py = torch.as_tensor(ys.ravel().astype(np.int32))
    pix = py.long() * RES[0] + px.long()
    xy = torch.stack([px, py], -1).float()
    total = 0.0
    for s in range(SPP):
        lanes = Lanes(pixel_idx=pix, sample_idx=torch.full_like(pix, s))
        p_film, _, _ = sampler.get_camera_sample(xy, lanes.pixel_idx,
                                                 lanes.sample_idx)
        ray = cam.generate_ray_differential(p_film)
        L = scrub_radiance(integ.li(ctx, ray, lanes, sampler,
                                    DimAllocator()))
        total = total + torch.mean(L)
    return total / SPP


CASES = {"kd0": dict(), "atlas level 0": dict(image_floor=True, atlas=True)}
# test_grad's camera faces the back wall squarely: on about half of the
# textured camera hits the two texture-space axes are equal to 1e-5, so
# the EWA lookup's major axis is picked by rounding, differently by XLA
# and torch (the forward, a constant texture, is the same to the last
# bit; the split of the gradient among texels is not: 1.08e-3 in norm,
# 1.73e-3 at the largest element). The JAX parity of the texel gradient
# maps the texture with sv = 1.25, which separates the axes.
SV = {"kd0": None, "atlas level 0, sv 1.25": 1.25}


def _jax_setup(case):
    from rustracer_tpu.scene.textures import UVMapping2D
    jctx, jcam, jsampler, jinteg = _setup(
        **CASES["kd0" if case == "kd0" else "atlas level 0"])
    if SV.get(case):
        jinteg.mat_set.materials[0].kd.mapping = UVMapping2D(sv=SV[case])
    return jctx, jcam, jsampler, jinteg


def _param(textures, case):
    return textures["const"]["kd0"] if case == "kd0" \
        else textures["images"][0][0]


def _port_grad(port, case):
    _port_loss(*port).backward()
    return _param(port[0].textures, case).grad.numpy()


@pytest.mark.parametrize("case", list(SV))
def test_grad_matches_jax(case):
    jctx, jcam, jsampler, jinteg = _jax_setup(case)
    jloss = _make_loss(jctx, jcam, jsampler, jinteg)

    def loss_of(p):
        tex = dict(jctx.textures)
        if case == "kd0":
            tex["const"] = {**tex["const"], "kd0": p}
        else:
            tex["images"] = [[p] + list(tex["images"][0][1:])]
        return jloss(jctx._replace(textures=tex))

    g_jax = np.array(jax.grad(loss_of)(_param(jctx.textures, case)))
    g_port = _port_grad(_port(jctx, jcam, jsampler, jinteg), case)
    assert np.isfinite(g_port).all() and np.abs(g_jax).max() > 0
    rel, elem = grad_errors([torch.as_tensor(g_port)],
                            [torch.as_tensor(g_jax)])
    print(f"{case}: ||g_port - g_jax|| / ||g_jax|| = {rel:.3g}, "
          f"max |g_port - g_jax| / max |g_jax| = {elem:.3g}")
    assert rel <= 1e-3 and elem <= 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_grad_matches_finite_differences(case):
    """Central differences of the port's own loss at the element of the
    largest gradient, on test_grad.py's setups (its estimator: detached
    sampling, so the differences converge to the estimator's
    gradient)."""
    port = _port(*_jax_setup(case))
    ctx, cam, sampler, integ = port
    g_port = _port_grad(port, case)
    assert np.isfinite(g_port).all() and g_port.sum() > 0
    idx = np.unravel_index(np.argmax(np.abs(g_port)), g_port.shape)
    eps = 1e-3 if case == "kd0" else 5e-3
    p0 = _param(ctx.textures, case).detach()

    def loss_at(v):
        p = p0.clone()
        p[idx] = v
        tex = dict(ctx.textures)
        if case == "kd0":
            tex["const"] = {**tex["const"], "kd0": p}
        else:
            tex["images"] = [[p] + list(tex["images"][0][1:])]
        with torch.no_grad():
            return float(_port_loss(dataclasses.replace(ctx, textures=tex),
                                    cam, sampler, integ))

    v = float(p0[idx])
    fd = (loss_at(v + eps) - loss_at(v - eps)) / (2 * eps)
    assert g_port[idx] == pytest.approx(fd, rel=2e-2, abs=1e-6)


def test_compacted_grad_matches_full_width(monkeypatch):
    """The textured dragon (small mesh, 32^2, 128-lane tiles) with the slab
    tiers opened to its tiles: the train step's gradients of every float
    leaf with compaction on (both tiers taken) equal those at full width,
    and every gradient is finite."""
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=3, res=(32, 32),
                                                     device="cpu")
    target = torch.full((32, 32, 3), 0.05)
    leaves, _ = float_leaves(ctx.textures)
    runs = []
    for min_b in (128, 1 << 30):
        monkeypatch.setattr(TP, "PATH_COMPACT_MIN_B", min_b)
        TP.reset_tiers()
        step = make_train_step(integ.li, cam, film, sampler, lr=1.0,
                               config=RenderConfig(max_lanes=128),
                               device="cpu")
        new, loss = step(ctx, target)
        runs.append((loss, [p - q for p, q in
                            zip(leaves, float_leaves(new.textures)[0])],
                     dict(TP.TIERS)))
    (loss_c, g_c, tiers), (loss_f, g_f, _) = runs
    assert tiers[2] > 0 and tiers[4] > 0, tiers
    torch.testing.assert_close(loss_c, loss_f, rtol=2e-5, atol=0)
    for a, b in zip(g_c, g_f):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-7)
    assert max(g.abs().max().item() for g in g_c) > 1e-6


def _jax_imagemap_cornell():
    from helpers import cornell_box as jax_cornell_box
    from helpers import cornell_camera, cornell_imagemap_materials
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext as JaxContext
    from rustracer_tpu.render.sampler import SamplerConfig
    geom, lights = jax_cornell_box()
    ms, textures = cornell_imagemap_materials(seed_base=10)
    return (JaxContext(geom=geom, lights=lights, textures=textures),
            cornell_camera(RES),
            Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5)),
            SamplerConfig(kind="02sequence", spp=SPP),
            PathIntegrator(mat_set=ms, max_depth=3))


def test_train_steps_match_sharded():
    """Two train steps (samples 0 and 1, lr 0.1) of the 16^2 Cornell with
    atlas imagemap walls: make_train_step against make_sharded_train_step
    on a 1 x 1 mesh."""
    from rustracer_tpu.parallel.mesh import (make_device_mesh,
                                             make_sharded_train_step)
    from rustracer_tpu_torch.render.film import Film
    from rustracer_tpu_torch.render.filters import Filter
    jctx, jcam, jfilm, jsampler, jinteg = _jax_imagemap_cornell()
    ctx, cam, sampler, integ = _port(jctx, jcam, jsampler, jinteg)
    ctx = dataclasses.replace(ctx, textures=convert.textures_from_jax(
        jctx.textures, device="cpu"))
    film = Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5))
    target = np.full(RES[::-1] + (3,), 0.2, np.float32)

    mesh = make_device_mesh(data=1, sample=1, devices=jax.devices()[:1])
    x0, y0, x1, y1 = jfilm.get_sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                         np.arange(y0, y1, dtype=np.int32))
    px, py = jnp.asarray(gx.ravel()), jnp.asarray(gy.ravel())
    valid = jnp.ones(px.shape, bool)
    jtrain = make_sharded_train_step(jinteg.li, jcam, jfilm, jsampler, mesh,
                                     lr=0.1)
    train = make_train_step(integ.li, cam, film, sampler, lr=0.1,
                            config=RenderConfig(max_lanes=px.shape[0]),
                            device="cpu")
    for s in range(2):
        jnew, jloss = jtrain(jctx, jnp.asarray(target), px, py, valid,
                             jnp.uint32(s))
        new, loss = train(ctx, torch.as_tensor(target), s)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
        jl = jax.tree.leaves(jnew.textures)
        jl = [np.asarray(x) for x in jl if jnp.issubdtype(x.dtype,
                                                          jnp.floating)]
        old, _ = float_leaves(ctx.textures)
        pl, _ = float_leaves(new.textures)
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-7)
        jold = [np.asarray(x) for x in jax.tree.leaves(jctx.textures)
                if jnp.issubdtype(x.dtype, jnp.floating)]
        rel, elem = grad_errors([(o - p) / 0.1 for o, p in zip(old, pl)],
                                [torch.as_tensor((o - b) / 0.1)
                                 for o, b in zip(jold, jl)])
        print(f"step {s}: loss {float(loss):.7g} (JAX {float(jloss):.7g}); "
              f"gradients ||d|| / ||g|| = {rel:.3g}, max {elem:.3g}")
        assert rel <= 1e-3 and elem <= 1e-2
        ctx, jctx = new, jnew


def test_launch_guard_raises():
    """With grad mode on, a kernel launch given a tensor that requires grad
    outside this package's autograd Functions raises before any build or
    launch (autograd cannot see through it); K7's slab move likewise."""
    table = torch.rand((8, 16), requires_grad=True)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.launch("row_gather", table, idx, 4, 16, torch.empty(4, 16))
    order = torch.arange(64, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="requires grad"):
        C.slab_move("slab_take", order, 32, [torch.rand(64, 3,
                                                        requires_grad=True)],
                    [torch.empty(32, 3)])
    with pytest.raises(RuntimeError, match="requires grad"):
        with K.plain_reference():
            K.launch("film_add_samples", torch.rand(4, 2),
                     torch.rand(4, 3, requires_grad=True))


def test_no_kernel_wrapper_gets_a_grad_tensor(monkeypatch):
    """On the card every kernel is a ctypes call that autograd cannot see
    through, and ``cuda.launch`` raises for a tensor that requires grad.
    Here, on the CPU, the wrappers of the kernels that carry no gradient
    (K1 traversal, K2 interaction rebuild) are watched through a compacted
    train step of the small textured dragon: none is handed a tensor that
    requires grad, so none would raise on the card, and the gradient goes
    only through the autograd Functions (K4, K5, K7, K8)."""
    from rustracer_tpu_torch.scene import tables as TB
    seen = []

    def watch(name, fn):
        def wrapped(*args, **kw):
            for a in list(args) + list(kw.values()):
                vals = vars(a).values() if dataclasses.is_dataclass(a) \
                    else [a]
                seen.extend(name for v in vals
                            if isinstance(v, torch.Tensor)
                            and v.requires_grad)
            return fn(*args, **kw)
        monkeypatch.setattr(TB, name, wrapped)

    watch("traverse16", TB.traverse16)
    watch("build_interaction", TB.build_interaction)
    monkeypatch.setattr(TP, "PATH_COMPACT_MIN_B", 128)
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=3, res=(32, 32),
                                                     device="cpu")
    TP.reset_tiers()
    step = make_train_step(integ.li, cam, film, sampler,
                           config=RenderConfig(max_lanes=128), device="cpu")
    step(ctx, torch.zeros(32, 32, 3))
    assert TP.TIERS[2] > 0 and TP.TIERS[4] > 0
    assert not seen, sorted(set(seen))
