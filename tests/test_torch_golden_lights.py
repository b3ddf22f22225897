"""The port's renders of ``scenes/veach-mis.pbrt`` (four sphere lights of
decreasing radius over four metal plates of increasing roughness: the cone
sampling of full spheres on both sides of MIS, the spatial grid over
quadric lights) and ``scenes/envmap-dof.pbrt`` (the sky EXR as an infinite
light over a matte floor and three spheres, a thin lens: Distribution2D
sampling, the escaped rays' MIS-weighted sky, shadow rays at t_max = inf)
on the CPU through its command line (``rustracer_tpu_torch.utils.cli`` with
``--cpu``, written as EXR and read back with the port's reader), each as
written (veach-mis 96 x 64 at 16 spp, depth 4; envmap-dof 64^2 at 16 spp,
depth 5), held to the JAX package's frozen golden image with
``tests/test_golden.py``'s tolerance (mean relative error 2e-3, 99th
percentile 2e-2) and to that file's structural checks. About 40 s
(veach-mis, 15 s of it the grid's plain contributions) and 6 s
(envmap-dof) on one CPU thread. A file of its own, so that xdist's
loadfile spreads the renders."""
import numpy as np
import pytest
import torch

from test_torch_golden import assert_matches_golden, render

torch.set_num_threads(1)


@pytest.fixture
def veach(tmp_path_factory):
    return render(tmp_path_factory, "veach-mis")


@pytest.fixture
def envmap(tmp_path_factory):
    return render(tmp_path_factory, "envmap-dof")


def test_veach_mis_matches_golden(veach):
    assert_matches_golden(veach, "veach-mis")


def test_veach_mis_structure(veach):
    """tests/test_golden.py's: the emitters are the brightest pixels, in
    the top band; the plates (the lights' glossy reflections) are much
    brighter than the backdrop below them."""
    h, w, _ = veach.shape
    lum = veach.sum(-1)
    ys, _ = np.unravel_index(np.argsort(lum.ravel())[-8:], (h, w))
    assert (ys < h // 3).all()
    plates = lum[int(0.3 * h): int(0.65 * h), w // 4: 3 * w // 4].mean()
    backdrop = lum[int(0.7 * h): int(0.9 * h), w // 4: 3 * w // 4].mean()
    assert plates > 3.0 * backdrop


def test_envmap_dof_matches_golden(envmap):
    assert_matches_golden(envmap, "envmap-dof")


def test_envmap_dof_structure(envmap):
    """tests/test_golden.py's: escaped camera rays see the blue sky at the
    top; the in-focus sphere has a sharp edge."""
    h, w, _ = envmap.shape
    top = envmap[: h // 6]
    assert top[..., 2].mean() > top[..., 0].mean()
    gx = np.abs(np.diff(envmap.sum(-1), axis=1))
    assert gx[int(0.45 * h): int(0.75 * h), w // 4: 3 * w // 4].max() > 0.1
