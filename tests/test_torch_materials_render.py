"""The slice on the materials the port gained last, on the CPU: balls of
substrate (testball-substrate), Disney (testball-disney), translucent, uber
(opacity 0.5, Kr and Kt) and a mix of substrate and Disney over a
checkerboard ``amount`` (``tests/test_torch_materials.py``'s BALLS) rendered
by both packages' path integrators at 16^2, 2 spp, depth 7 from one scene
text, every pixel compared with ``tests/test_golden.py``'s measure (mean
relative error below 2e-3, 99th percentile below 2e-2); the observed
numbers are printed. A file apart from test_torch_materials.py, so that
its JAX compiles (about half a minute a scene here) go to another worker."""
import pytest
import torch

from test_torch_materials import assert_slice_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["substrate", "disney", "translucent",
                                  "uber", "mix"])
def test_slice_renders_match_jax(name):
    assert_slice_matches_jax(name)
