"""Port parity of the path chain's plain twins (ops/pathshade.py: K21
path_hit_emit, K22 path_scatter_lambert, K23 path_nee_add), the kernel
route of integrators/path.py that runs them, and the route's choice.

The same seeded numpy inputs (camera rays, or rays from seeded points in
seeded directions; a seeded path state) go through the JAX package's
``PathIntegrator._hit_and_emit`` and ``_scatter`` and through the port's
on the kernel route (on the CPU: the twins, with the shadow ray's any hit
between K22's and K23's), on the small matte dragon (the JAX scene's own
tables) and on the Cornell box (each package's own tables, which are
bit-equal: tests/test_torch_cornell.py).

Tolerance: as tests/test_torch_path.py, each lane's float outputs (L,
beta, the ray, prev_pdf) within 1e-4 relative (1e-5 absolute) on at least
99% of the lanes, the bool and int fields (alive, prev_spec, path_len,
the hit's valid mask) equal on every lane."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rustracer_tpu.core.ray import Ray as JaxRay
from rustracer_tpu.integrators.path import _PathState as JaxState
from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.ray import Ray
from rustracer_tpu_torch.integrators.path import PathIntegrator, _PathState
from rustracer_tpu_torch.ops import pathshade as PS
from rustracer_tpu_torch.render.renderer import Lanes
from rustracer_tpu_torch.scenes import build_cornell, dragon_materials

from test_torch_geometry import jax_dragon_matte, port_ctx_from_jax

torch.set_num_threads(1)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
RES = (32, 32)
N = RES[0] * RES[1]
FLOAT_FIELDS = ("ray_o", "ray_d", "ray_tmax", "L", "beta", "prev_pdf",
                "prev_p")
EXACT_FIELDS = ("alive", "prev_spec", "path_len")
# the sampler dimensions of the scatter (any, the same in both packages)
DIMS = (5, 3, 6, 4, 7)


def _scenes(name):
    """-> (JAX ctx, sampler, integrator, port ctx, sampler, integrator)."""
    if name == "matte dragon":
        jctx, _, _, jsampler, jinteg = jax_dragon_matte(res=RES, spp=1)
        ms, _ = dragon_materials()
        return (jctx, jsampler, jinteg, port_ctx_from_jax(jctx),
                convert.sampler_from_jax(jsampler),
                PathIntegrator(mat_set=ms, max_depth=5))
    jctx, _, _, jsampler, jinteg = bench.build_cornell()
    ctx, _, _, _, integ = build_cornell(res=RES, device="cpu")
    return (jctx, jsampler, jinteg, ctx, convert.sampler_from_jax(jsampler),
            integ)


_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        _CACHE[name] = _scenes(name)
    return _CACHE[name]


def _inputs(name, first, seed):
    """Seeded rays and path state (numpy): camera-like rays from the
    scene's eye for ``first``, else rays from seeded points of the scene's
    box in seeded directions, with prev_p their origins."""
    rng = np.random.default_rng(seed)
    if name == "matte dragon":
        lo, hi, eye = (-1.5, 0.0, -1.5), (1.5, 1.5, 1.5), (0.0, 1.1, -3.4)
    else:
        lo, hi, eye = (0.02,) * 3, (0.98,) * 3, (0.5, 0.5, -1.4)
    if first:
        o = np.broadcast_to(np.asarray(eye, np.float32), (N, 3)).copy()
        target = rng.uniform(lo, hi, (N, 3))
        d = target - o
    else:
        o = rng.uniform(lo, hi, (N, 3))
        d = rng.normal(size=(N, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    st = dict(
        ray_o=o.astype(np.float32), ray_d=d.astype(np.float32),
        ray_tmax=np.full(N, np.inf, np.float32),
        L=rng.uniform(0, 0.5, (N, 3)).astype(np.float32),
        beta=(np.ones((N, 3)) if first else rng.uniform(0.02, 1.2, (N, 3))
              ).astype(np.float32),
        eta_scale=np.ones(N, np.float32),
        alive=np.ones(N, bool) if first else rng.uniform(size=N) > 0.1,
        prev_pdf=(np.ones(N) if first else rng.uniform(0, 2, N)
                  ).astype(np.float32),
        prev_spec=np.ones(N, bool) if first else rng.uniform(size=N) < 0.2,
        prev_p=o.astype(np.float32),
        path_len=(np.zeros(N) if first else rng.integers(0, 3, N)
                  ).astype(np.int32))
    return st


def _jax_state(st):
    return JaxState(**{k: jnp.asarray(v) for k, v in st.items()},
                    obs=jnp.zeros(2, jnp.int32))


def _port_state(st):
    return _PathState(**{k: torch.as_tensor(v) for k, v in st.items()})


def _close(name, got, ref, exact):
    got, ref = np.asarray(got), np.asarray(ref)
    if exact:
        bad = got != ref
        assert not bad.any(), f"{name}: {int(bad.sum())} lanes differ"
        return
    with np.errstate(invalid="ignore"):
        ok = (got == ref) | (np.abs(got - ref) <= 1e-5 + 1e-4 * np.abs(ref))
    if ok.ndim > 1:
        ok = ok.all(-1)
    print(f"{name}: {int((~ok).sum())} of {ok.size} lanes diverge")
    assert ok.mean() >= 0.99, name


def _hit(name, first, seed=0):
    jctx, jsampler, jinteg, ctx, sampler, integ = _scene(name)
    st = _inputs(name, first, seed)
    jst, pst = _jax_state(st), _port_state(st)
    jray = JaxRay(o=jst.ray_o, d=jst.ray_d, t_max=jst.ray_tmax)
    jsi, jst2 = jax.jit(lambda r, s: jinteg._hit_and_emit(jctx, r, s, first))(
        jray, jst)
    assert integ.kernel_route(ctx)
    ray = Ray(o=pst.ray_o, d=pst.ray_d, t_max=pst.ray_tmax)
    si, pst2 = integ._hit_and_emit(ctx, ray, pst, first, route=True)
    return (jctx, jsampler, jinteg, jsi, jst2), (ctx, sampler, integ, si,
                                                  pst2)


@pytest.mark.parametrize("first", [True, False], ids=["camera", "bounce"])
@pytest.mark.parametrize("name", ["matte dragon", "cornell"])
def test_hit_and_emit_matches_jax(name, first):
    """K21's twin on the kernel route against the JAX package's
    ``_hit_and_emit``: L, alive, path_len and the hit's valid mask."""
    (_, _, _, jsi, jst), (_, _, _, si, st) = _hit(name, first)
    _close("valid", si.valid.numpy(), jsi.valid, True)
    for f in ("alive", "path_len"):
        _close(f, getattr(st, f).numpy(), getattr(jst, f), True)
    _close("L", st.L.numpy(), jst.L, False)
    # many rays hit, and some bounce rays take emission
    assert si.valid.float().mean() > 0.3
    if not first:
        assert (st.L.numpy() > _inputs(name, first, 0)["L"]).any()


@pytest.mark.parametrize("rr_on", [False, True], ids=["no rr", "rr"])
@pytest.mark.parametrize("name", ["matte dragon", "cornell"])
def test_scatter_matches_jax(name, rr_on):
    """K22's twin, the shadow ray's any hit and K23's twin on the kernel
    route against the JAX package's ``_scatter`` on the state that
    ``_hit_and_emit`` left (a bounce of seeded rays): every field of the
    path state."""
    (jctx, jsampler, jinteg, jsi, jst), (ctx, sampler, integ, si, st) = \
        _hit(name, False, seed=1)
    pix = np.arange(N, dtype=np.uint32)
    jl = JaxLanes(pixel_idx=jnp.asarray(pix),
                  sample_idx=jnp.full(N, 2, jnp.uint32))
    lanes = Lanes(pixel_idx=torch.as_tensor(pix.astype(np.int64)),
                  sample_idx=torch.full((N,), 2, dtype=torch.int64))
    jout = jax.jit(lambda s, t: jinteg._scatter(
        jctx, jsampler, jl, s, t, *DIMS, rr_on))(jsi, jst)
    out = integ._scatter(ctx, sampler, lanes, si, st, *DIMS, rr_on,
                         route=True)
    for f in FLOAT_FIELDS:
        _close(f, getattr(out, f).numpy(), getattr(jout, f), False)
    for f in EXACT_FIELDS:
        _close(f, getattr(out, f).numpy(), getattr(jout, f), True)
    assert out.alive.any() and (out.L > st.L).any()   # NEE adds light
    if rr_on:
        # roulette ended some paths the bounce kept
        off = integ._scatter(ctx, sampler, lanes, si, st, *DIMS, False,
                             route=True)
        assert (off.alive & ~out.alive).any()


def test_twins_are_the_general_chain():
    """On the CPU the kernel route computes what the general chain
    computes, bit for bit: a bounce of the Cornell box through both."""
    _, (ctx, sampler, integ, si, st) = _hit("cornell", False, seed=2)
    pix = torch.arange(N, dtype=torch.int64)
    lanes = Lanes(pixel_idx=pix, sample_idx=torch.zeros_like(pix))
    a = integ._scatter(ctx, sampler, lanes, si, st, *DIMS, True, route=True)
    b = integ._scatter(ctx, sampler, lanes, si, st, *DIMS, True, route=False)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _route_of(scene):
    """The kernel route's choice for a scene of the port, built small."""
    from rustracer_tpu_torch.scene.api import parse_scene, parse_scene_string
    from rustracer_tpu_torch.scenes import build_dragon_matte, build_instanced
    if scene == "matte dragon":
        ctx, *_, integ, _ = build_dragon_matte(sub=1, res=(8, 8), spp=1,
                                               device="cpu")
    elif scene == "cornell":
        ctx, _, _, _, integ = build_cornell(res=(8, 8), device="cpu")
    elif scene == "cornell walls":
        ctx, _, _, _, integ = build_cornell(res=(8, 8), imagemap_walls=(1, 2),
                                            device="cpu")
    elif scene == "gallery":
        ctx, _, _, _, integ = build_instanced(subdiv=1, res=(8, 8), spp=1,
                                              grid=2, device="cpu")
    elif scene == "veach-mis":
        # its sphere lights under the uniform pick: the route reads the
        # lights and lobes, not the pick, and the spatial grid's plain
        # build takes half a minute on one thread
        with open(os.path.join(SCENES, "veach-mis.pbrt")) as f:
            text = f.read().replace(
                'Integrator "path"',
                'Integrator "path" "string lightsamplestrategy" "uniform"')
        b = parse_scene_string(text, device="cpu").scene
        assert b.context().light_grid is None
        ctx, integ = b.context(), b.integrator
    elif scene == "cornell-box mix":
        # the floor a mix of two matte materials: Lambertian lobes alone,
        # two a material (under the uniform pick, as veach-mis)
        with open(os.path.join(SCENES, "cornell-box.pbrt")) as f:
            text = f.read().replace(
                'Integrator "path"',
                'Integrator "path" "string lightsamplestrategy" "uniform"'
            ).replace(
                'Material "matte" "rgb Kd" [0.725 0.71 0.68]',
                'MakeNamedMaterial "a" "string type" "matte" '
                '"rgb Kd" [0.725 0.71 0.68]\n'
                'MakeNamedMaterial "b" "string type" "matte" '
                '"rgb Kd" [0.2 0.3 0.4]\n'
                'Material "mix" "string namedmaterial1" "a" '
                '"string namedmaterial2" "b"', 1)
        b = parse_scene_string(text, device="cpu").scene
        ctx, integ = b.context(), b.integrator
        assert integ.mat_set.types_present() == PS.LAMBERT
        assert integ.mat_set.max_lobes == 2
    else:
        b = parse_scene(os.path.join(SCENES, f"{scene}.pbrt"),
                        device="cpu").scene
        ctx, integ = b.context(), b.integrator
    return integ.kernel_route(ctx)


@pytest.mark.parametrize("scene,taken", [
    ("matte dragon", True), ("cornell", True), ("cornell walls", True),
    ("cornell-box", True), ("gallery", True), ("testball-matte", True),
    ("testball-glass", False), ("veach-mis", False), ("envmap-dof", False),
    ("cornell-box mix", False)])
def test_route_is_taken_by_what_the_scene_holds(scene, taken):
    """One Lambertian lobe a material under triangle lights takes K21-K23
    (the dragons, both Cornell boxes, the gallery, the matte testball over
    its quadric); a glass ball, sphere lights, a sky and a mix of two
    matte materials keep the general chain."""
    assert _route_of(scene) is taken


@pytest.mark.parametrize("kernel", ["K21", "K22", "K23"])
def test_wrappers_refuse_a_gradient(kernel):
    """The wrappers refuse an input that requires grad, naming the ROADMAP
    item of their backward, on the CPU as on the card."""
    _, (ctx, sampler, integ, si, st) = _hit("cornell", False, seed=3)
    st = dataclasses.replace(st, beta=st.beta.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="item B1.1"):
        if kernel == "K21":
            PS.path_hit_emit(ctx.lights, si, st.ray_d, st, 0.5)
        elif kernel == "K22":
            si2, lobes = integ.mat_set.shade(si, ctx)
            u = torch.full((N, 2), 0.5)
            PS.path_scatter_lambert(ctx.lights, si2, lobes, st,
                                    torch.zeros(N, dtype=torch.int32), 0.5,
                                    u, u[:, 0], u)
        else:
            PS.path_nee_add(st.L, st.beta, torch.zeros(N, dtype=torch.bool))


def test_train_step_keeps_the_general_chain(monkeypatch):
    """A Cornell train step (textures that require grad) takes the general
    chain, not the twins, and its gradient is finite: the chain whose
    gradient tests/test_torch_grad.py holds against jax.grad."""
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    from rustracer_tpu_torch.render.renderer import RenderConfig

    def refuse(*a, **k):
        raise AssertionError("a train step took the kernel route")
    for name in ("path_hit_emit", "path_scatter_lambert", "path_nee_add"):
        monkeypatch.setattr(PS, name, refuse)
    ctx, cam, film, sampler, integ = build_cornell(
        res=(16, 16), max_depth=3, imagemap_walls=(1, 2), device="cpu")
    assert integ.kernel_route(ctx)
    step = make_train_step(integ.li, cam, film, sampler,
                           config=RenderConfig(max_lanes=256), device="cpu")
    new, loss = step(ctx, torch.zeros(16, 16, 3))
    assert torch.isfinite(loss)
    moved = [not torch.equal(a, b) for a, b in zip(
        new.textures["images"][0], ctx.textures["images"][0])]
    assert any(moved)
