"""The port's render of ``scenes/cornell-box.pbrt`` on the CPU, through its
command line (``rustracer_tpu_torch.utils.cli`` with ``--cpu``, written as
EXR and read back with the port's reader), held to the JAX package's frozen
golden image with ``tests/test_golden.py``'s tolerance (mean relative error
2e-3, 99th percentile 2e-2) and to its structural checks of the Cornell
box. The scene takes the spatial light grid (two light triangles) at 64
voxels, 64^2 at 16 spp, depth 5."""
import os

import numpy as np
import pytest
import torch

from rustracer_tpu_torch.render.imageio import read_image
from rustracer_tpu_torch.utils import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_cache = {}


def render_cornell(tmp_path_factory):
    if "img" not in _cache:
        out = str(tmp_path_factory.mktemp("golden") / "cornell.exr")
        rc = cli.main([os.path.join(REPO, "scenes", "cornell-box.pbrt"),
                       "--cpu", "-o", out])
        assert rc == 0
        _cache["img"] = read_image(out)
    return _cache["img"]


@pytest.fixture
def img(tmp_path_factory):
    return render_cornell(tmp_path_factory)


def test_matches_golden(img):
    ref = np.load(os.path.join(REPO, "tests", "goldens",
                               "cornell-box.npz"))["img"]
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    assert mean_err < 2e-3 and p99 < 2e-2, (mean_err, p99)


def test_structure(img):
    h, w, _ = img.shape
    left = img[h // 4: 3 * h // 4, : w // 5]
    right = img[h // 4: 3 * h // 4, -w // 5:]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()
    yx = np.unravel_index(np.argmax(img.sum(-1)), (h, w))
    assert yx[0] < h // 3
    assert w // 4 < yx[1] < 3 * w // 4
    assert img.max() <= 20.0
    assert 0.05 < img.mean() < 1.0
