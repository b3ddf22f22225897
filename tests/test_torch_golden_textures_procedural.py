"""The slice on the CPU: tools/texture_work.py's ``textures-procedural``, a marble ball bumped by a scaled wrinkled texture over a mix of two
checkerboards of textures (a uv, a windy) by an fbm,
rendered by both packages' path integrators at 16^2, 2 spp, depth 7 from
one scene text, every pixel within tests/test_golden.py's measure (mean
relative error below 2e-3, 99th percentile below 2e-2); the observed
numbers are printed. A file of its own, so that xdist spreads the JAX
compiles (about a minute a scene here)."""
import torch

from test_torch_textures import assert_scene_matches_jax

torch.set_num_threads(1)


def test_render_matches_jax(tmp_path):
    assert_scene_matches_jax("textures-procedural", tmp_path)
