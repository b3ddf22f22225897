"""Port parity of the textures, mappings and bump mapping
(``rustracer_tpu_torch/scene/textures.py``, ``Material.apply_bump`` and
``MaterialSet.shade``'s texture routes) against the JAX package, on the
CPU, on the interactions of a 16 x 16 camera wavefront (the renderer's
differential scale) of ``tools/texture_work.py``'s TEXTURE_SCENES at 64^2.
The interactions are the JAX package's, handed to both; each scene is
parsed by both packages.

- Every texture each scene's materials hold, sub-textures included
  (constant, scale, mix, uv, checkerboards of textures, fbm, wrinkled,
  windy, marble over the 3D mapping of a translated declaration, float and
  spectrum imagemaps over the uv and planar mappings: trilinear, 8-tap at
  anisotropy 4 and 8, exact at 16, clamped), evaluated through the
  per-texture route (``MaterialSet.lookups``: the scene's texel rows and
  no atlas values): within 2e-5 absolute (the exact lookup's tolerance,
  tests/test_torch_mipmap.py; the rest within 1e-6 there).
- ``apply_bump`` on a ball of each material class (matte, Oren-Nayar
  matte, plastic, mirror, glass, metal, substrate, translucent, uber,
  Disney, Fourier) with a constant, a noise (scaled wrinkled) and an
  imagemap bump: the shading frame within 1e-4 absolute per component.
  The bump's finite differences divide its displacements' difference by a
  footprint of about 1e-3, which turns the displacements' last-bit
  differences into about 1e-4 of the slope.
- ``MaterialSet.shade`` on each scene: the atlas's value at the hit and
  K17's plain twin at the moved hits (the image bump), the textured
  materials' lobes within 2e-5 absolute, types and active flags bit for
  bit, the bumped frame within 1e-4.
- A train step over a Fourier BSDF is refused by name when it is built,
  for either device; one whose sampled directions depend on a trained
  leaf (a bump map over images, a glossy lobe's roughness) raises naming
  ROADMAP item B12 when it traces such a ray; the scenes that rendered
  before these textures call no lookup of ops/mipmap.py, no noise and no
  Fourier function.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch.scene.api import parse_scene, parse_scene_string
from rustracer_tpu_torch.tools import texture_work as TW
from test_torch_materials import port_si, wavefront

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_cache = {}


def parsed(text):
    if text not in _cache:
        _cache[text] = (jax_parse_string(text).scene,
                        parse_scene_string(text, device="cpu").scene)
    return _cache[text]


def scene(name):
    d = tempfile.mkdtemp()
    return parsed(TW.scene_text(name, bsdf_dir=d))


def _textures(m):
    """The attribute paths of every texture ``m`` evaluates, sub-textures
    and the materials it holds included."""
    for k, v in vars(m).items():
        if hasattr(v, "lobe_rows"):
            yield from ((k,) + p for p in _textures(v))
        elif hasattr(v, "evaluate"):
            yield (k,)
            yield from ((k,) + p for p in _textures(v))


def _at(obj, path):
    for k in path:
        obj = getattr(obj, k)
    return obj


def _close(a, b, atol, label):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = np.broadcast_arrays(a, b)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= atol, (label, err)


@pytest.mark.parametrize("name", sorted(TW.TEXTURE_SCENES))
def test_every_texture_matches(name):
    jb, pb = scene(name)
    jsi = wavefront(jb)
    si = port_si(jsi)
    jctx = jb.context()
    kinds = set()
    look = pb.material_set.lookups(pb.textures, "cpu")
    for jm, pm in zip(jb.integrator.mat_set.materials,
                      pb.material_set.materials):
        for path in _textures(jm):
            jt, pt = _at(jm, path), _at(pm, path)
            if pt is None:   # a matte's sigma, the constant 0
                continue
            assert type(jt).__name__ == type(pt).__name__, path
            kinds.add(type(pt).__name__)
            out = pt.evaluate(si, pb.textures, look)
            ref = jt.evaluate(jsi, jctx)
            _close(out.numpy(), ref, 2e-5, path)
    expected = {"textures-procedural": {
        "ScaleTexture", "MixTexture", "UVTexture", "CheckerboardTexture",
        "FbmTexture", "WrinkledTexture", "WindyTexture", "MarbleTexture"},
        "textures-image": {"ImageTexture"},
        "testball-fourier": {"CheckerboardTexture"},
        "textures-train": {"ImageTexture", "MixTexture"}}[name]
    assert expected <= kinds, kinds


_BALLS = {
    "matte": 'Material "matte" "rgb Kd" [0.5 0.4 0.3]',
    "oren-nayar": 'Material "matte" "float sigma" [20]',
    "plastic": 'Material "plastic"',
    "mirror": 'Material "mirror"',
    "glass": 'Material "glass"',
    "metal": 'Material "metal" "float roughness" [0.1]',
    "substrate": 'Material "substrate"',
    "translucent": 'Material "translucent"',
    "uber": 'Material "uber" "rgb Kr" [0.2 0.2 0.2]',
    "disney": 'Material "disney" "float metallic" [0.3]',
    "fourier": 'Material "fourier" "string bsdffile" "{bsdf}"',
}
_BUMPS = {
    "constant": 'Texture "bump" "float" "constant" "float value" [0.3]',
    "noise": 'Texture "w" "float" "wrinkled" "integer octaves" [6]\n'
    'Texture "bump" "float" "scale" "texture tex1" "w" "float tex2" [0.02]',
    "image": f'Texture "bump" "float" "imagemap" "string filename" '
    f'"{TW.GRID}" "float uscale" [8] "float vscale" [4] '
    '"float scale" [0.004]',
}


def _bump_text(ball, bump, bsdf_dir):
    material = _BALLS[ball].format(bsdf=TW.write_fourier_table(
        os.path.join(bsdf_dir, "t.bsdf"))) + ' "texture bumpmap" "bump"'
    text = TW.scene_text("testball-fourier", bsdf_dir=bsdf_dir)
    head, tail = text.split('Material "fourier"')
    tail = tail.split("\n", 1)[1]
    # no spatial grid: the frame needs no light
    head = head.replace('"integer maxdepth" [7]', '"integer maxdepth" [7] '
                        '"string lightsamplestrategy" "uniform"')
    return head + _BUMPS[bump] + "\n  " + material + "\n" + tail


def _bump_reference(bump, bsdf_dir):
    """The JAX package's bumped frame of a matte ball's wavefront (the
    frame depends on the bump texture and the interactions alone, not on
    the ball's material): computed once a bump kind."""
    key = ("bump", bump)
    if key not in _cache:
        jb, _ = parsed(_bump_text("matte", bump, bsdf_dir))
        jsi = wavefront(jb)
        ref = jb.integrator.mat_set.materials[-1].apply_bump(jsi,
                                                             jb.context())
        _cache[key] = jsi, ref
    return _cache[key]


@pytest.mark.parametrize("bump", sorted(_BUMPS))
@pytest.mark.parametrize("ball", sorted(_BALLS))
def test_apply_bump_matches(ball, bump, tmp_path):
    jsi, ref = _bump_reference(bump, str(tmp_path))
    pb = parse_scene_string(_bump_text(ball, bump, str(tmp_path)),
                            device="cpu").scene
    pm = pb.material_set.materials[-1]
    kind = "Matte" if ball == "oren-nayar" else ball.capitalize()
    assert type(pm).__name__ == f"{kind}Material" and pm.bump_tex is not None
    si = port_si(jsi)
    out = pm.apply_bump(si, pb.textures,
                        pb.material_set.lookups(pb.textures, "cpu"))
    ball_lanes = np.asarray(jsi.material) == len(
        pb.material_set.materials) - 1
    assert ball_lanes.sum() > 30
    for f in ("ns", "ss", "ts"):
        _close(getattr(out, f).numpy()[ball_lanes],
               np.asarray(getattr(ref, f))[ball_lanes], 1e-4, f)
    assert not torch.equal(out.ns, si.ns)


@pytest.mark.parametrize("name", sorted(TW.TEXTURE_SCENES))
def test_shade_matches(name):
    jb, pb = scene(name)
    jsi = wavefront(jb)
    jsi2, jl = jb.integrator.mat_set.shade(jsi, jb.context())
    si2, lobes = pb.material_set.shade(port_si(jsi), pb.context())
    np.testing.assert_array_equal(lobes.type.numpy(), np.asarray(jl.type))
    np.testing.assert_array_equal(lobes.active.numpy(),
                                  np.asarray(jl.active))
    # a Lambertian lobe reads no A and B: the reference writes A = 1, B = 0
    # there for a sigma that is the constant 0, the port leaves them 0
    jp = np.array(jl.params)
    lam = np.asarray(jl.type) == 0
    jp[..., 14:16][lam] = lobes.params.numpy()[..., 14:16][lam]
    _close(lobes.params.numpy(), jp, 2e-5, "params")
    _close(lobes.eta.numpy(), jl.eta, 0.0, "eta")
    for f in ("ns", "ss", "ts"):
        _close(getattr(si2, f).numpy(), getattr(jsi2, f), 1e-4, f)
    if name == "testball-fourier":
        assert lobes.fourier is not None


def assert_scene_matches_jax(name, tmp_path):
    """TEXTURE_SCENES[name] at 16^2, 2 spp, depth 7, rendered by both
    packages' path integrators from one scene text: every pixel within
    tests/test_golden.py's measure (mean relative error below 2e-3, 99th
    percentile below 2e-2); the observed numbers are printed."""
    text = TW.scene_text(name, res=16, spp=2, bsdf_dir=str(tmp_path))
    ref = np.asarray(jax_parse_string(text).scene.render())
    pb = parse_scene_string(text, device="cpu").scene
    assert pb.integrator.max_depth == 7 and pb.sampler.spp == 2
    img = pb.render().numpy()
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-3
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    print(f"{name} at 16^2, 2 spp: mean relative error {mean_err:.3g}, "
          f"p99 {p99:.3g}")
    assert mean_err < 2e-3 and p99 < 2e-2, (mean_err, p99)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", ["textures-image", "testball-fourier"])
def test_train_step_refused(name, device):
    """testball-fourier: the step is refused when it is built, for either
    device (K19 has no backward: ROADMAP item B11b). textures-image: its
    ball's image bump map makes the bounce directions depend on the texels,
    so a step raises naming item B12 when it traces such a ray: on the CPU
    one step at 16^2; for the card, the refusal stands before any launch
    (a ray that requires grad raises there whatever its device, here the
    meta device's), and the step builds (K17's lookups have K20)."""
    from rustracer_tpu_torch.core.ray import Ray
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    from rustracer_tpu_torch.scene import tables as TB
    if name == "testball-fourier":
        _, pb = scene(name)
        with pytest.raises(NotImplementedError, match="K19.*B11b"):
            make_train_step(pb.integrator.li, pb.camera, pb.film,
                            pb.sampler, device=device)
        return
    pb = parsed(TW.scene_text(name, res=16, spp=1,
                              bsdf_dir=tempfile.mkdtemp()))[1]
    if device == "cpu":
        step = make_train_step(pb.integrator.li, pb.camera, pb.film,
                               pb.sampler, device="cpu")
        with pytest.raises(NotImplementedError,
                           match="sampled ray direction.*B12"):
            step(pb.context(), torch.zeros(16, 16, 3))
        return
    d = torch.ones((4, 3), device="meta", requires_grad=True)
    ray = Ray(o=torch.zeros((4, 3), device="meta"), d=d,
              t_max=torch.ones(4, device="meta"))
    for fn in (TB.scene_intersect, TB.scene_intersect_passthrough,
               TB.scene_intersect_p):
        with pytest.raises(NotImplementedError,
                           match="sampled ray direction.*B12"):
            fn(pb.geom, ray)


def test_gradient_through_a_sampled_direction_is_refused():
    """The plastic Cornell box at 16^2 (the short block's white matte made
    plastic, roughness 0.1): its glossy lobe's sampled directions depend on
    the trained roughness, so one train step on the CPU raises naming
    ROADMAP item B12 where the reference returns NaN gradients."""
    from rustracer_tpu_torch.parallel.mesh import make_train_step
    pb = parse_scene_string(TW.plastic_cornell_text(16), device="cpu").scene
    assert type(pb.material_set.materials[-1]).__name__ == "PlasticMaterial"
    step = make_train_step(pb.integrator.li, pb.camera, pb.film, pb.sampler,
                           lr=1.0, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="sampled ray direction.*B12"):
        step(pb.context(), torch.zeros(16, 16, 3))


def test_earlier_scenes_take_no_new_route():
    """testball-matte (a checkerboard floor) renders without a call of the
    per-texture lookups, the noise or the Fourier BSDF."""
    from rustracer_tpu_torch.core import noise
    from rustracer_tpu_torch.ops import fourier, mipmap
    calls = []
    patched = [(mod, name) for mod, names in (
        (mipmap, ("trilinear_plain", "ewa_plain", "ewa_exact_plain")),
        (noise, ("fbm_plain", "turbulence_plain")),
        (fourier, ("f_plain", "pdf_plain", "sample_f_plain")))
        for name in names]
    saved = [getattr(m, n) for m, n in patched]
    try:
        for m, n in patched:
            setattr(m, n, lambda *a, _n=n, **k: calls.append(_n))
        pb = parse_scene(os.path.join(REPO, "scenes", "testball-matte.pbrt"),
                         device="cpu").scene
        pb.film = dataclasses.replace(pb.film, full_resolution=(16, 16))
        img = pb.render(sample_stop=1)
    finally:
        for (m, n), f in zip(patched, saved):
            setattr(m, n, f)
    assert calls == [] and bool(torch.isfinite(img).all())
