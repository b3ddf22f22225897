"""The port's renders of ``scenes/cornell-box.pbrt`` and
``scenes/testball-matte.pbrt`` on the CPU, through its command line
(``rustracer_tpu_torch.utils.cli`` with ``--cpu``, written as EXR and read
back with the port's reader), held to the JAX package's frozen golden
images with ``tests/test_golden.py``'s tolerance (mean relative error 2e-3,
99th percentile 2e-2) and to structural checks. The Cornell box takes the
spatial light grid (two light triangles) at 64 voxels, 64^2 at 16 spp,
depth 5; testball-matte a matte sphere (K14 and K2's quadric branch on a
card) over a checkerboard floor, 64^2 at 16 spp, depth 7: the ball's
pixels vary less than the floor's checks."""
import os

import numpy as np
import pytest
import torch

from rustracer_tpu_torch.render.imageio import read_image
from rustracer_tpu_torch.utils import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_cache = {}


def render(tmp_path_factory, name):
    if name not in _cache:
        out = str(tmp_path_factory.mktemp("golden") / f"{name}.exr")
        rc = cli.main([os.path.join(REPO, "scenes", f"{name}.pbrt"),
                       "--cpu", "-o", out])
        assert rc == 0
        _cache[name] = read_image(out)
    return _cache[name]


@pytest.fixture
def img(tmp_path_factory):
    return render(tmp_path_factory, "cornell-box")


@pytest.fixture
def testball(tmp_path_factory):
    return render(tmp_path_factory, "testball-matte")


def assert_matches_golden(img, name):
    ref = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))["img"]
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    err = np.abs(img - ref)
    scale = max(float(ref.mean()), 1e-3)
    mean_err = float(err.mean()) / scale
    p99 = float(np.percentile(err, 99)) / scale
    assert mean_err < 2e-3 and p99 < 2e-2, (mean_err, p99)


def test_matches_golden(img):
    assert_matches_golden(img, "cornell-box")


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


def test_testball_matte_matches_golden(testball):
    assert_matches_golden(testball, "testball-matte")


def test_testball_matte_structure(testball):
    """The matte ball (the image's middle third) is near-uniform beside
    the floor's checks (its bottom fifth), as tests/test_golden.py's
    mirror test takes it; energy bounded and the mean in a sane band."""
    h, w, _ = testball.shape
    lum = testball.sum(-1)
    ball = lum[h // 3: 2 * h // 3, w // 3: 2 * w // 3]
    floor = lum[-h // 5:]
    assert ball.std() < 0.6 * floor.std(), (ball.std(), floor.std())
    assert testball.max() <= 20.0 and 0.05 < testball.mean() < 1.0
