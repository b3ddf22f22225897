"""Port parity of the direct-lighting, Whitted, ambient-occlusion and normal
integrators (``rustracer_tpu_torch/integrators/direct.py``, ``whitted.py``,
``ao.py``, ``normal.py`` over ``common.py``'s estimate_direct and specular
tree, ``scene/lights.py``'s pdf_li and infinite_le_one) against the JAX
package, on the CPU: each scene of
``tools/integrator_work.py`` CASES on the Cornell box (AO also by its
other name, "ambientocclusion") and testball-glass (Whitted and direct
lighting: both specular branches, 31 nodes at depth 5), parsed by both
packages from one scene text at 32^2, 2 spp, rendered
through each package's scene bundle. Sampler dimensions are allocated as
the reference allocates them, so lanes compare one to one. veach-mis
under direct lighting with per-light sample counts is held to the JAX
package's integrator lane by lane
(test_per_light_sample_counts_follow_the_rows).

Tolerance: tests/test_golden.py's (mean relative error below 2e-3, 99th
percentile below 2e-2), and tighter: mean 1e-4, p99 1e-3 (observed about
1e-7 and 1e-6 on the Cornell box, 3e-6 and 5e-5 on the glass ball, where
the refractions' float rounding differs); the observed numbers are
printed.
"""
import numpy as np
import pytest
import torch

from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.tools import integrator_work as IW

torch.set_num_threads(1)
CLASSES = {"directlighting": "DirectLightingIntegrator",
           "directlighting-one": "DirectLightingIntegrator",
           "whitted": "WhittedIntegrator", "ao": "AOIntegrator",
           "ambientocclusion": "AOIntegrator",
           "normal": "NormalIntegrator"}
CASES = [c for c in IW.CASES if c[0] != "veach-mis"] + [
    ("cornell-box", "ambientocclusion"), ("testball-glass", "directlighting")]


@pytest.mark.parametrize("name,integrator", CASES)
def test_render_matches_jax(name, integrator):
    text = IW.scene_text(name, integrator, res=(32, 32), spp=2)
    pb = parse_scene_string(text, device="cpu").scene
    assert type(pb.integrator).__name__ == CLASSES[integrator]
    if integrator.startswith("directlighting"):
        assert pb.integrator.strategy == ("one" if integrator.endswith(
            "one") else "all")
    img = pb.render().numpy()
    ref = np.asarray(jax_parse_string(text).scene.render())
    assert img.shape == ref.shape == (32, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 1e-3
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    print(f"{name} under {integrator}: mean relative error {mean_err:.3g}, "
          f"p99 {p99:.3g}")
    assert mean_err < 1e-4 and p99 < 1e-3, (mean_err, p99)


def test_per_light_sample_counts_follow_the_rows():
    """veach-mis under direct lighting at 16^2, 1 spp: each light's
    "nsamples" lands on the light row the JAX package gives it (the
    integrator's counts aligned with the rows), and the strategy "all"
    draws and averages each light's samples as the JAX package does:
    sample 0's radiance on every lane equals its integrator's, run op by
    op on the same camera rays (test_torch_scene_api._li_both; its
    compiled render takes minutes to compile here), within 1e-5 absolute
    and relative (observed about 2e-7)."""
    from test_torch_scene_api import _li_both
    text = IW.scene_text("veach-mis", "directlighting", res=(16, 16), spp=1)
    pb = parse_scene_string(text, device="cpu").scene
    jb = jax_parse_string(text).scene
    assert pb.integrator.light_nsamples == IW.VEACH_NSAMPLES
    assert tuple(jb.integrator.light_nsamples) == IW.VEACH_NSAMPLES
    assert pb.lights.n_lights == len(IW.VEACH_NSAMPLES)
    li, ref = _li_both(pb, jb)
    assert li.shape == ref.shape == (256, 3) and np.isfinite(li).all()
    print(f"veach-mis under directlighting: sample 0 radiance mean "
          f"{ref.mean():.4g}, max abs error {np.abs(li - ref).max():.3g}")
    np.testing.assert_allclose(li, ref, rtol=1e-5, atol=1e-5)
