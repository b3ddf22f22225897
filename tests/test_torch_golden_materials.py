"""The port's renders of the seven material testballs on the CPU through
its command line (``rustracer_tpu_torch.utils.cli`` with ``--cpu``, written
as EXR and read back with the port's reader), each held to the JAX
package's frozen golden image with ``tests/test_golden.py``'s tolerance
(mean relative error 2e-3, 99th percentile 2e-2): glass and rough glass
(FRESNEL_SPECULAR, microfacet reflection and transmission), mirror
(specular reflection), plastic (Lambertian under Trowbridge-Reitz), metal
and rough metal (conductor Fresnel), and the textured plastic ball (an
atlas imagemap Kd on the sphere, over an imagemap floor). Each is a sphere
over a floor under a 2-triangle light, 64^2 at 16 spp, depth 7 (the
textured ball depth 5); about 10-15 s each here."""
import os

import pytest
import torch

from test_torch_golden import assert_matches_golden, render

torch.set_num_threads(1)

MATERIALS = ("glass", "mirror", "plastic", "metal", "roughglass",
             "roughmetal", "textured")


@pytest.mark.parametrize("name", MATERIALS)
def test_testball_matches_golden(tmp_path_factory, name):
    img = render(tmp_path_factory, f"testball-{name}")
    assert_matches_golden(img, f"testball-{name}")
    assert img.max() <= 20.0 and 0.02 < img.mean() < 1.0


def test_mirror_and_glass_differ_from_matte(tmp_path_factory):
    """The ball's material shows: mirror and glass each differ from the
    matte testball over the ball's pixels."""
    matte = render(tmp_path_factory, "testball-matte")
    h, w, _ = matte.shape
    ball = (slice(h // 3, 2 * h // 3), slice(w // 3, 2 * w // 3))
    for name in ("mirror", "glass"):
        img = render(tmp_path_factory, f"testball-{name}")
        assert abs(img[ball] - matte[ball]).mean() > 0.05, name
