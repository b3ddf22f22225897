"""The port's command line (``python -m rustracer_tpu_torch.utils.cli``)
in a fresh interpreter on the CPU: a 1-spp render of the Cornell box
written as EXR is read back by both packages' readers, and one of
testball-glass prints its phases and launches; a scene with a
feature the port does not render exits non-zero naming the feature; the
flags that are not ported exit non-zero saying so."""
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


@pytest.mark.parametrize("scene,feature", [
    ("scenes/veach-mis.pbrt", "an area light on Shape 'sphere'"),
    ("scenes/simple.pbrt", "LightSource 'point'")])
def test_unsupported_scene_exits_with_the_feature(tmp_path, scene, feature):
    proc = run_cli(scene, "--cpu", "-o", str(tmp_path / "x.exr"))
    assert proc.returncode != 0
    assert feature in proc.stderr and "not ported yet" in proc.stderr


@pytest.mark.parametrize("flag", [["--checkpoint", "ck.npz"],
                                  ["--profile", "trace"]])
def test_unported_flags_exit(flag):
    proc = run_cli("scenes/cornell-box.pbrt", "--cpu", *flag)
    assert proc.returncode != 0 and "not ported (A17)" in proc.stderr
