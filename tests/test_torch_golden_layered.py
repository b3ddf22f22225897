"""The port's renders of testball-substrate (FresnelBlend) and
testball-disney (the Disney lobes, its specular on the Disney Fresnel, M =
6) on the CPU through its command line (``rustracer_tpu_torch.utils.cli``
with ``--cpu``, written as EXR and read back with the port's reader), each
held to the JAX package's frozen golden image with
``tests/test_golden.py``'s tolerance (mean relative error 2e-3, 99th
percentile 2e-2). Each is a sphere over a checkerboard floor under a
2-triangle light, 64^2 at 16 spp, depth 7: about 13 s (substrate) and 21 s
(Disney) on one CPU thread. A file apart from test_torch_golden_materials.py, so that
the two go to another worker."""
import pytest
import torch

from test_torch_golden import assert_matches_golden, render

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["substrate", "disney"])
def test_testball_matches_golden(tmp_path_factory, name):
    img = render(tmp_path_factory, f"testball-{name}")
    assert_matches_golden(img, f"testball-{name}")
    assert img.max() <= 20.0 and 0.02 < img.mean() < 1.0
