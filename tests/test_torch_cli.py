"""The port's command line (``python -m rustracer_tpu_torch.utils.cli``)
in a fresh interpreter on the CPU: a 1-spp render of the Cornell box
written as EXR is read back by both packages' readers, and one of
testball-glass prints its phases and launches; ``scenes/simple.pbrt``
(spheres and a disk alone: no triangle, a point light and a disk light)
renders at 1 spp (about 25 s); a scene with a feature the port does not
render (a bump map, the Fourier material) exits non-zero naming the
feature; the flags that are not ported exit non-zero saying so."""
import os
import subprocess
import sys

import numpy as np
import pytest

from rustracer_tpu.render.imageio import read_image as jax_read
from rustracer_tpu_torch.render.imageio import read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "rustracer_tpu_torch.utils.cli",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cpu_render_writes_a_readable_exr(tmp_path):
    out = str(tmp_path / "c.exr")
    proc = run_cli("scenes/cornell-box.pbrt", "--cpu", "--spp", "1", "-o",
                   out, "-v")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    img = read_image(out)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3
    np.testing.assert_array_equal(img, jax_read(out))
    for phase in ("scene/spatial light distribution", "scene/BVH build",
                  "render"):
        assert phase in proc.stdout
    assert "launches {" in proc.stdout


def test_cpu_render_of_a_glass_scene(tmp_path):
    """testball-glass (FRESNEL_SPECULAR and microfacet lobes, a sphere)
    at 1 spp: the image and the phase and launch lines as for the Cornell
    box."""
    out = str(tmp_path / "g.exr")
    proc = run_cli("scenes/testball-glass.pbrt", "--cpu", "--spp", "1", "-o",
                   out, "-v")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    img = read_image(out)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3
    for phase in ("scene/BVH build", "render"):
        assert phase in proc.stdout
    assert "launches {" in proc.stdout


def test_cpu_render_of_a_scene_of_quadrics(tmp_path):
    """scenes/simple.pbrt: no triangle mesh (make_geometry's dummy
    triangle), a point light and an area light on a disk through the
    spatial grid, at 1 spp."""
    out = str(tmp_path / "s.exr")
    proc = run_cli("scenes/simple.pbrt", "--cpu", "--spp", "1", "-o", out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    img = read_image(out)
    assert img.shape == (150, 200, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-2


UNPORTED = {
    "bumpmap": ('Texture "b" "float" "constant" "float value" [1]\n'
                'Material "matte" "texture bumpmap" "b"', "bumpmap"),
    "fourier": ('Material "fourier"', "Material 'fourier'"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unsupported_scene_exits_with_the_feature(tmp_path, case):
    world, feature = UNPORTED[case]
    scene = tmp_path / f"{case}.pbrt"
    scene.write_text(
        'Camera "perspective"\nFilm "image" "integer xresolution" [8] '
        '"integer yresolution" [8]\nWorldBegin\n' + world
        + '\nShape "trianglemesh" "integer indices" [0 1 2] '
        '"point P" [0 0 1 1 0 1 0 1 1]\nWorldEnd\n')
    proc = run_cli(str(scene), "--cpu", "-o", str(tmp_path / "x.exr"))
    assert proc.returncode != 0
    assert feature in proc.stderr and "not ported yet" in proc.stderr


@pytest.mark.parametrize("flag", [["--checkpoint", "ck.npz"],
                                  ["--profile", "trace"]])
def test_unported_flags_exit(flag):
    proc = run_cli("scenes/cornell-box.pbrt", "--cpu", *flag)
    assert proc.returncode != 0 and "not ported (A17)" in proc.stderr
