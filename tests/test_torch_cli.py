"""The port's command line (``python -m rustracer_tpu_torch.utils.cli``)
in a fresh interpreter on the CPU: a 1-spp render of the Cornell box
written as EXR is read back by both packages' readers, and one of
testball-glass prints its phases and launches; ``scenes/simple.pbrt``
(spheres and a disk alone: no triangle, a point light and a disk light)
renders at 1 spp (about 25 s); scenes with instances and with alpha and
shadow-alpha cut-outs render at 1 spp under the middle split and the
hlbvh name; scenes with the Whitted integrator and the random sampler,
both refused once, render; ``--checkpoint`` renders the image of a run
without it and leaves no file, and ``--profile`` writes a Chrome trace;
the counter table follows the phase timings."""
import json
import os
import re
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


# the options of each case, refused once: the Whitted integrator until
# ROADMAP.md section A item 16 ported it, the random sampler until item 17
UNPORTED = {
    "whitted": ('Integrator "whitted"', "'whitted'", 16),
    "random": ('Sampler "random"', "'random'", 17),
}


def small_scene(tmp_path, options="", name="s"):
    """An 8 x 8 scene file of one triangle under a point light."""
    scene = tmp_path / f"{name}.pbrt"
    scene.write_text(
        'Camera "perspective"\nFilm "image" "integer xresolution" [8] '
        '"integer yresolution" [8]\n' + options + '\nWorldBegin\n'
        'LightSource "point" "rgb I" [2 2 2]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2] '
        '"point P" [0 0 1 1 0 1 0 1 1]\nWorldEnd\n')
    return str(scene)


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unsupported_scene_exits_with_the_feature(tmp_path, case):
    """The Whitted integrator's scene and the random sampler's (a point
    light added) render a finite image; the random sampler's table counts
    its 4 default samples a pixel."""
    options, feature, item = UNPORTED[case]
    out = str(tmp_path / "x.exr")
    proc = run_cli(small_scene(tmp_path, options, case), "--cpu", "-o", out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    img = read_image(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3
    if item == 17:
        assert re.search(rf"^ +Camera rays traced +{8 * 8 * 4}$",
                         proc.stdout, re.M), proc.stdout


_CARD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
         '[-0.5 -0.5 0  0.5 -0.5 0  0.5 0.5 0  -0.5 0.5 0] '
         '"float uv" [0 0 1 0 1 1 0 1]')
# what the port refused until the rest of the geometry was ported: the
# world block of each case and its Accelerator
GEOMETRY = {
    "instancing": ('Accelerator "bvh" "string splitmethod" "middle"',
                   f'ObjectBegin "card"\n{_CARD}\nObjectEnd\n'
                   + "".join(f'TransformBegin\nTranslate {x} 0 0\n'
                             'ObjectInstance "card"\nTransformEnd\n'
                             for x in (-0.6, 0.6))),
    "alpha": ('Accelerator "hlbvh"',
              'Texture "g" "float" "imagemap" "string filename" '
              '"scenes/textures/grid.png"\n'
              f'{_CARD} "float alpha" [0]\nTranslate 0 0 1\n'
              f'{_CARD} "texture shadowalpha" "g"\n'
              'Material "none"\nShape "sphere" "float radius" [2.5]'),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_cpu_render_of_a_geometry_scene(tmp_path, case):
    """Instanced cards under the middle split, and a cut-out card before
    a shadow-alpha card inside a medium-interface sphere under the hlbvh
    name, through the command line at 1 spp: a finite, lit image."""
    options, world = GEOMETRY[case]
    scene = tmp_path / f"{case}.pbrt"
    scene.write_text(
        'LookAt 0 0 -3  0 0 0  0 1 0\nCamera "perspective" "float fov" [50]\n'
        'Film "image" "integer xresolution" [16] "integer yresolution" [16]\n'
        'Sampler "02sequence" "integer pixelsamples" [1]\n' + options
        + '\nWorldBegin\nLightSource "point" "rgb I" [20 20 20] '
        '"point from" [0 0 -2]\n' + world + '\nWorldEnd\n')
    out = str(tmp_path / "x.exr")
    proc = run_cli(str(scene), "--cpu", "-o", out, "-v")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    img = read_image(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3


@pytest.mark.parametrize("flag", [["--checkpoint", "ck.npz"],
                                  ["--profile", "trace"]])
def test_unported_flags_exit(tmp_path, flag):
    """The flags refused until the run surface was ported: a 2-spp
    ``--checkpoint`` run written every sample gives the image of the run
    without the flag and leaves no checkpoint; ``--profile`` writes a JSON
    trace with ``traceEvents`` into its directory. Both print the counter
    table."""
    scene = small_scene(tmp_path)
    out = str(tmp_path / "x.exr")
    arg = str(tmp_path / flag[1])
    extra = ["--checkpoint-every", "1"] if flag[0] == "--checkpoint" else []
    proc = run_cli(scene, "--cpu", "--spp", "2", "-o", out, flag[0], arg,
                   *extra)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Statistics:" in proc.stdout and "Camera rays traced" in \
        proc.stdout
    if flag[0] == "--checkpoint":
        assert not os.path.exists(arg)
        ref = str(tmp_path / "ref.exr")
        assert run_cli(scene, "--cpu", "--spp", "2", "-o", ref).returncode \
            == 0
        np.testing.assert_array_equal(read_image(out), read_image(ref))
        return
    traces = [f for f in os.listdir(arg) if f.endswith(".json")]
    assert len(traces) == 1, os.listdir(arg)
    with open(os.path.join(arg, traces[0])) as f:
        assert "traceEvents" in json.load(f)
    assert f"trace to {os.path.join(arg, traces[0])}" in proc.stdout
