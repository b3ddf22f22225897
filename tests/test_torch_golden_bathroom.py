"""``scenes/bathroom.pbrt`` through the port on the CPU: two rooms, 35
materials (substrate, uber, Disney, mirror, glass, metal) with 18 EXR
imagemaps in the shared atlas, a window of two light triangles, two sphere
lamps (the cone), the sky as an infinite light, a thin lens and the
spatial grid over every light (35 x 21 x 64 voxels x 5 lights).

``test_scene_builds`` mirrors tests/test_golden.py's TestBathroom
.test_scene_builds through the port's parser (about 15 s on one CPU
thread, most of it the grid's plain contributions). The render as written
(320 x 180 at 16 spp, depth 5: about 7 minutes on one thread) is held to
the JAX package's frozen golden with tests/test_golden.py's tolerance
(mean relative error 2e-3, 99th percentile 2e-2) and that file's
structural checks; it is marked slow (chip_smoke.py holds it on the
card)."""
import os

import numpy as np
import pytest
import torch

from rustracer_tpu_torch.scene.api import parse_scene
from test_torch_golden import REPO, assert_matches_golden, render

torch.set_num_threads(1)


def test_scene_builds():
    sc = parse_scene(os.path.join(REPO, "scenes", "bathroom.pbrt"),
                     device="cpu").scene
    assert len(sc.material_set.materials) >= 20
    assert len(sc.textures["images"]) >= 18
    assert sc.textures["atlas_meta"].shape[0] >= 18
    assert sc.light_grid is not None               # spatial strategy
    assert sc.lights.n_lights >= 4                 # lamps + window + sky
    assert sc.lights.kinds >= {"tri", "sphere", "cone", "infinite"}
    assert sc.lights.inf_rows == (sc.lights.n_lights - 1,)
    assert sc.camera.lens_radius > 0.0             # DoF
    pmf = sc.light_grid.pmf
    assert pmf.shape[1] == sc.lights.n_lights
    assert torch.allclose(pmf.sum(-1), torch.ones(pmf.shape[0]), atol=1e-5)


@pytest.fixture
def bathroom(tmp_path_factory):
    return render(tmp_path_factory, "bathroom")


@pytest.mark.slow
def test_matches_golden(bathroom):
    assert_matches_golden(bathroom, "bathroom")


@pytest.mark.slow
def test_structure(bathroom):
    """tests/test_golden.py's: the window (right quarter) is the brightest
    region; the interior is lit."""
    h, w, _ = bathroom.shape
    assert np.isfinite(bathroom).all()
    assert bathroom[:, int(w * 0.72):].mean() > \
        1.5 * bathroom[:, : w // 2].mean()
    assert (bathroom[:, : w // 2].sum(-1) > 1e-3).mean() > 0.9
