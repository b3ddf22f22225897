"""Port parity of the texel gradient through the per-texture image lookups
(hand kernel K17 forward, K20 backward; on the CPU their plain versions):
the port's gradients against ``jax.grad`` of the JAX package's, against
the port's own central finite differences, and the one-device train step
(``parallel/mesh.py`` make_train_step) against the JAX
``make_sharded_train_step`` on a 1 x 1 mesh, over
``tools/texture_work.py``'s matte scene ``textures-train``.

Setups: tests/test_grad.py's (the 16^2 Cornell box, 4 spp, depth 3, the
loss the mean radiance over pixels and samples) with its white walls'
4x4 imagemap looked up per texture: trilinear (``ImageTexture(0,
trilinear=True)``, the anchor of tests/test_grad.py
test_imagemap_texel), the 8-tap EWA (``max_aniso`` 4, which keeps it off
the shared atlas) and the exact EWA (``max_aniso`` 16); the map's v scaled
by 1.25, which separates the texture-space axes of the camera's square
view of the back wall (tests/test_torch_grad.py SV). textures-train at
32^2, 1 sample a step, depth 3: the planar floor (8-tap), the trilinear
back wall, on the green wall the mix of a trilinear and an 8-tap imagemap
by a trilinear float imagemap (each nested, so each looked up per
texture), the exact lookup on the red wall (black wrap), an atlas imagemap
on the short block (K5's quad rows, so K17 reads them too).

Bounds: against JAX, ||g_port - g_jax|| / ||g_jax|| <= 1e-3 and every
element within 1e-2 of max |g_jax| (tests/test_torch_grad.py's: float
sums in other orders through three bounces); against finite differences
rel 2e-2 (tests/test_grad.py); train steps: losses and updated leaves
within 1e-4 relative, the gradients within the JAX bound above. The
observed errors are printed."""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grad import _make_loss, _setup
from test_torch_grad import _port, _port_loss
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch.parallel.mesh import (float_leaves, grad_errors,
                                               make_train_step)
from rustracer_tpu_torch.render.renderer import RenderConfig
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.scene.atlas import build_atlas_meta
from rustracer_tpu_torch.tools import texture_work as TW

torch.set_num_threads(1)
# the white walls' lookup: ImageTexture's trilinear flag and max_aniso
MODES = {"trilinear": (True, 8.0), "ewa": (False, 4.0),
         "exact": (False, 16.0)}
SV = 1.25


def _jax_setup(mode):
    from rustracer_tpu.scene.textures import UVMapping2D
    jctx, jcam, jsampler, jinteg = _setup(image_floor=True)
    kd = jinteg.mat_set.materials[0].kd
    kd.trilinear, kd.max_aniso = MODES[mode]
    kd.mapping = UVMapping2D(sv=SV)
    return jctx, jcam, jsampler, jinteg


def _port_setup(mode):
    """The port's scene of the setup, its level leaves requiring grad and
    its textures given the atlas metadata the per-texture lookups read
    (no material of the setup has an atlas slot)."""
    jctx, jcam, jsampler, jinteg = _jax_setup(mode)
    ctx, cam, sampler, integ = _port(jctx, jcam, jsampler, jinteg)
    tex = ctx.textures
    am = build_atlas_meta([[lv.detach().numpy() for lv in pyr]
                           for pyr in tex["images"]])
    tex["atlas_meta"] = torch.as_tensor(am["atlas_meta"])
    tex["atlas_levels"] = torch.as_tensor(am["atlas_levels"])
    assert not integ.mat_set.atlas_prep()[0]
    assert integ.mat_set.per_texture_images()
    return (jctx, jcam, jsampler, jinteg), (ctx, cam, sampler, integ)


def _level0_grad(port):
    _port_loss(*port).backward()
    return port[0].textures["images"][0][0].grad.numpy()


def test_trilinear_texel_gradient_matches_jax():
    (jctx, jcam, jsampler, jinteg), port = _port_setup("trilinear")
    jloss = _make_loss(jctx, jcam, jsampler, jinteg)

    def loss_of(level0):
        tex = dict(jctx.textures)
        tex["images"] = [[level0] + list(tex["images"][0][1:])]
        return jloss(jctx._replace(textures=tex))

    g_jax = np.array(jax.grad(loss_of)(jctx.textures["images"][0][0]))
    g_port = _level0_grad(port)
    assert np.isfinite(g_port).all() and np.abs(g_jax).max() > 0
    rel, elem = grad_errors([torch.as_tensor(g_port)],
                            [torch.as_tensor(g_jax)])
    print(f"trilinear level 0: ||g_port - g_jax|| / ||g_jax|| = {rel:.3g}, "
          f"max |g_port - g_jax| / max |g_jax| = {elem:.3g}")
    assert rel <= 1e-3 and elem <= 1e-2


@pytest.mark.parametrize("mode", ["ewa", "exact"])
def test_texel_gradient_matches_finite_differences(mode):
    """Central differences of the port's own loss at the level-0 texel of
    the largest gradient (the estimator's sampling is detached from the
    texels, tests/test_grad.py)."""
    _, port = _port_setup(mode)
    ctx, cam, sampler, integ = port
    g = _level0_grad(port)
    assert np.isfinite(g).all() and g.sum() > 0
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 5e-3
    p0 = ctx.textures["images"][0][0].detach()

    def loss_at(v):
        p = p0.clone()
        p[idx] = v
        tex = dict(ctx.textures)
        tex["images"] = [[p] + list(tex["images"][0][1:])]
        with torch.no_grad():
            return float(_port_loss(dataclasses.replace(ctx, textures=tex),
                                    cam, sampler, integ))

    v = float(p0[idx])
    fd = (loss_at(v + eps) - loss_at(v - eps)) / (2 * eps)
    print(f"{mode}: d loss / d texel {idx} = {g[idx]:.6g}, central "
          f"difference {fd:.6g}")
    assert g[idx] == pytest.approx(fd, rel=2e-2, abs=1e-6)


def test_train_steps_match_sharded():
    """Two train steps (samples 0 and 1, lr 1) of textures-train at 32^2:
    make_train_step against make_sharded_train_step on a 1 x 1 mesh, the
    lookups of every mode counted on the way."""
    from rustracer_tpu.parallel.mesh import (make_device_mesh,
                                             make_sharded_train_step)
    text = TW.scene_text("textures-train", res=32, spp=1,
                         bsdf_dir=tempfile.mkdtemp())
    jb = jax_parse_string(text).scene
    pb = parse_scene_string(text, device="cpu").scene
    mesh = make_device_mesh(data=1, sample=1, devices=jax.devices()[:1])
    # the context replicated on the mesh, as the step returns it: the
    # second step then reuses the first one's compile
    jctx = jax.device_put(jb.context(), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    ctx = pb.context()
    target = np.full((32, 32, 3), 0.2, np.float32)
    x0, y0, x1, y1 = jb.film.get_sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                         np.arange(y0, y1, dtype=np.int32))
    px, py = jnp.asarray(gx.ravel()), jnp.asarray(gy.ravel())
    valid = jnp.ones(px.shape, bool)
    lr = 1.0
    jtrain = make_sharded_train_step(jb.integrator.li, jb.camera, jb.film,
                                     jb.sampler, mesh, lr=lr)
    train = make_train_step(pb.integrator.li, pb.camera, pb.film, pb.sampler,
                            lr=lr, config=RenderConfig(max_lanes=1024),
                            device="cpu")
    for s in range(2):
        jnew, jloss = jtrain(jctx, jnp.asarray(target), px, py, valid,
                             jnp.uint32(s))
        with TW.count_calls({}) as calls:
            new, loss = train(ctx, torch.as_tensor(target), s)
        assert set(calls) == {"lookup_trilinear", "lookup_ewa",
                              "lookup_ewa_exact"}, calls
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
        jl = [np.asarray(x) for x in jax.tree.leaves(jnew.textures)
              if jnp.issubdtype(x.dtype, jnp.floating)]
        old, _ = float_leaves(ctx.textures)
        pl, _ = float_leaves(new.textures)
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-7)
        jold = [np.asarray(x) for x in jax.tree.leaves(jctx.textures)
                if jnp.issubdtype(x.dtype, jnp.floating)]
        grads = [(o - p) / lr for o, p in zip(old, pl)]
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        rel, elem = grad_errors(grads, [torch.as_tensor((o - b) / lr)
                                        for o, b in zip(jold, jl)])
        print(f"step {s}: loss {float(loss):.7g} (JAX {float(jloss):.7g}); "
              f"gradients ||d|| / ||g|| = {rel:.3g}, max {elem:.3g}")
        assert rel <= 1e-3 and elem <= 1e-2
        ctx, jctx = new, jnew


def test_float_leaves_rebuild_a_fourier_table_set():
    """parallel/mesh.py float_leaves over a texture tree that holds a
    FourierTableSet (a NamedTuple with an int field): its float tables are
    leaves in field order, and rebuild puts new leaves back field by field
    into a FourierTableSet, the int tables and m_pad untouched."""
    from rustracer_tpu_torch.ops.fourier import (FourierTableSet,
                                                 make_table_set)
    ts = make_table_set([TW.fourier_table(), TW.fourier_table(seed=6)]).to(
        "cpu")
    tree = {"const": {"kd": torch.ones(3)}, "fourier": ts,
            "images": [[torch.zeros(2, 2, 3), torch.zeros(1, 1, 3)]]}
    leaves, rebuild = float_leaves(tree)
    floats = [f for f in FourierTableSet._fields
              if isinstance(getattr(ts, f), torch.Tensor)
              and getattr(ts, f).is_floating_point()]
    assert floats == ["mu", "a_flat", "a0", "cdf", "eta"]
    assert len(leaves) == 1 + len(floats) + 2
    new = rebuild([x + 1.0 for x in leaves])
    assert isinstance(new["fourier"], FourierTableSet)
    for f in FourierTableSet._fields:
        a, b = getattr(new["fourier"], f), getattr(ts, f)
        if f in floats:
            assert torch.equal(a, b + 1.0), f
        else:
            assert a is b, f
    assert torch.equal(new["const"]["kd"], torch.full((3,), 2.0))
    assert torch.equal(new["images"][0][1], torch.ones(1, 1, 3))
