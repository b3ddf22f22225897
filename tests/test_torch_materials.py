"""Port parity of the materials and of the slice as a whole against the JAX
package, on the CPU.

``MaterialSet.shade`` of the port against the JAX one on the interactions
of a 16 x 16 camera wavefront (every fourth pixel of the 64^2 film, sample
0, the renderer's differential scale) of each of the nine testball scenes
(glass, mirror, plastic, metal, roughglass, roughmetal, textured,
substrate, disney) and of the balls of ``tools/profile_step.py``'s BALLS
(testball-glass with another ball material): a matte with ``"float
sigma" [20]`` (Oren-Nayar), translucent, uber (opacity 0.5, Kr and Kt), a
thin Disney, and a mix of substrate and Disney with a constant
``amount``, with a checkerboard ``amount`` (per lane) and over a
substrate whose Kd is the floor's checkerboard (a textured sub-material
without images: the mix is shaded per lane).
Each scene is parsed by both packages; the port shades with its own parse
and with the JAX scene's materials and textures carried over by
``convert.py``. The interactions are the JAX package's, handed to both.
Tolerances: lobe types, active flags and eta bit for bit; params bit for
bit in the slots the reference copies from a constant, the computed ones
(alpha from ``roughness_to_alpha`` or Disney's roughness and anisotropy,
Oren-Nayar's A and B, the clearcoat's gloss) within 1e-5
relative, the per-lane textures (checkerboard, atlas imagemap) within
1e-5 absolute, as ``tests/test_torch_textured.py`` holds K5's plain
version; a Lambertian lobe's A and B, which it never reads, are not
compared (the reference writes A = 1, B = 0 there where sigma is the
constant 0). M and the material ids match; the port's ``types_present`` is the
reference's, less OREN_NAYAR where every matte's sigma is the constant 0
(the reference lists it there, and its lanes take LAMBERTIAN_REFL).

The slice: testball-glass and testball-plastic rendered by both packages'
path integrators at 16^2, 2 spp, depth 7 from one scene text, every pixel
compared with ``tests/test_golden.py``'s measure (mean relative error below
2e-3, 99th percentile below 2e-2); the observed numbers are printed.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core.interaction import compute_differentials
from rustracer_tpu.ops import bsdf as JB
from rustracer_tpu.render.renderer import Lanes as JaxLanes
from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu.scene.tables import scene_intersect
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.interaction import Interaction
from rustracer_tpu_torch.ops import bsdf as PB
from rustracer_tpu_torch.scene import materials as PMAT
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.tools.profile_step import BALLS, scene_text

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("glass", "mirror", "plastic", "metal", "roughglass", "roughmetal",
          "textured", "substrate", "disney")
# the slots of a lobe's params that a material computes: alpha_x, alpha_y,
# Oren-Nayar's A and B (Disney's roughness or metallic, the clearcoat's
# gloss)
COMPUTED = [10, 11, 14, 15]


_cache = {}


def parsed(name):
    """-> (JAX bundle, port bundle) of a testball (or a ball of BALLS),
    parsed from the scene's directory."""
    if name not in _cache:
        text = scene_text(f"testball-{name}")
        cwd = os.getcwd()
        os.chdir(os.path.join(REPO, "scenes"))
        try:
            _cache[name] = (jax_parse_string(text).scene,
                            parse_scene_string(text, device="cpu").scene)
        finally:
            os.chdir(cwd)
    return _cache[name]


def wavefront(jb):
    """The JAX interactions of a 16 x 16 camera wavefront."""
    w, h = jb.film.full_resolution
    ys, xs = np.mgrid[2:h:h // 16, 2:w:w // 16]
    px, py = xs.ravel(), ys.ravel()
    pix = jnp.asarray((py * w + px).astype(np.uint32))
    lanes = JaxLanes(pixel_idx=pix, sample_idx=jnp.zeros_like(pix))
    p_film, p_lens, _ = jb.sampler.get_camera_sample(
        jnp.asarray(np.stack([px, py], -1).astype(np.float32)),
        lanes.pixel_idx, lanes.sample_idx)
    ray = jb.camera.generate_ray_differential(p_film, p_lens)
    ray = ray.scaled_differentials(1.0 / np.sqrt(jb.sampler.spp))
    return compute_differentials(scene_intersect(jb.geom, ray), ray)


def port_si(jsi):
    return Interaction(**{f.name: torch.as_tensor(np.array(getattr(
        jsi, f.name))) for f in dataclasses.fields(Interaction)})


def assert_lobes_match(lobes, jl, jsi, per_lane_mats):
    np.testing.assert_array_equal(lobes.type.numpy(), np.asarray(jl.type))
    np.testing.assert_array_equal(lobes.active.numpy(), np.asarray(jl.active))
    np.testing.assert_array_equal(lobes.eta.numpy().view(np.int32),
                                  np.asarray(jl.eta).view(np.int32))
    p, jp = lobes.params.numpy(), np.asarray(jl.params)
    lane = np.isin(np.asarray(jsi.material), per_lane_mats)
    const = [k for k in range(16) if k not in COMPUTED]
    np.testing.assert_array_equal(p[~lane][..., const].view(np.int32),
                                  jp[~lane][..., const].view(np.int32))
    # a Lambertian lobe reads no A and B: the reference writes A = 1, B = 0
    # there for a sigma that is the constant 0, the port leaves them 0
    lam = np.asarray(jl.type) == JB.LAMBERTIAN_REFL
    jp = jp.copy()
    jp[..., 14:16][lam] = p[..., 14:16][lam]
    np.testing.assert_allclose(p[..., COMPUTED], jp[..., COMPUTED],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(p[lane], jp[lane], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", SCENES + tuple(BALLS))
def test_shade_matches_jax(name):
    jb, pb = parsed(name)
    jms, pms = jb.integrator.mat_set, pb.material_set
    assert pms.max_lobes == jms.max_lobes
    assert len(pms.materials) == len(jms.materials)
    jt, pt = set(jms.types_present()), set(pms.types_present())
    assert pt <= jt and jt - pt <= {JB.OREN_NAYAR}
    if name == "oren-nayar":
        assert PB.OREN_NAYAR in pt
    jsi = wavefront(jb)
    _, jl = jms.shade(jsi, jb.context())
    per_lane = [i for i, m in enumerate(pms.materials)
                if not PMAT._is_uniform(m)]
    if name in ("mix", "mix-textured"):
        assert per_lane[-1] == len(pms.materials) - 1
    si = port_si(jsi)
    for ms, textures in ((pms, pb.textures), (
            convert.material_set_from_jax(jms, jb.textures),
            convert.textures_from_jax(jb.textures, device="cpu"))):
        ctx = dataclasses.replace(pb.context(), textures=textures)
        si2, lobes = ms.shade(si, ctx)
        assert si2 is si
        assert_lobes_match(lobes, jl, jsi, per_lane)
    mat = np.asarray(jsi.material)
    ball = len(jms.materials) - 1
    # the wavefront sees the ball and the floor; the ball's lobes are live
    assert (mat == ball).mean() > 0.1 and (mat == 1).mean() > 0.1
    assert lobes.active.numpy()[mat == ball].any(-1).all()


def slice_text(name):
    """testball-<name> at 16^2, 2 spp."""
    return scene_text(f"testball-{name}").replace(
        '"integer xresolution" [64] "integer yresolution" [64]',
        '"integer xresolution" [16] "integer yresolution" [16]').replace(
        '"integer pixelsamples" [16]', '"integer pixelsamples" [2]')


@pytest.mark.parametrize("name", ["glass", "plastic"])
def test_slice_renders_match_jax(name):
    assert_slice_matches_jax(name)


def assert_slice_matches_jax(name):
    text = slice_text(name)
    assert "[16]" in text and "[2]" in text
    ref = np.asarray(jax_parse_string(text).scene.render())
    pb = parse_scene_string(text, device="cpu").scene
    assert pb.integrator.max_depth == 7 and pb.sampler.spp == 2
    img = pb.render().numpy()
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    print(f"testball-{name} at 16^2, 2 spp: mean relative error "
          f"{mean_err:.3g}, p99 {p99:.3g}")
    assert mean_err < 2e-3 and p99 < 2e-2, (mean_err, p99)
