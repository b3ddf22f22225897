"""The slice on the CPU: tools/texture_work.py's ``testball-fourier``, a Fourier ball (tools/texture_work.py fourier_table: 16 knots,
3 channels, orders up to 8, written at run time) over the checkerboard
floor,
rendered by both packages' path integrators at 16^2, 2 spp, depth 7 from
one scene text, every pixel within tests/test_golden.py's measure (mean
relative error below 2e-3, 99th percentile below 2e-2); the observed
numbers are printed. A file of its own, so that xdist spreads the JAX
compiles (about a minute a scene here)."""
import torch

from test_torch_textures import assert_scene_matches_jax

torch.set_num_threads(1)


def test_render_matches_jax(tmp_path):
    assert_scene_matches_jax("testball-fourier", tmp_path)
