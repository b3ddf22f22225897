"""The port imports no JAX: a fresh interpreter imports its main path (and
every module of the package), renders a tiny frame of the matte and of
the textured dragon, takes a train step of the textured dragon and of the
Cornell box with imagemap walls and the Cornell's fwd+bwd loss, renders
the Cornell box through render_sharded and takes a sharded train step on a
world-size-1 gloo group in process, parses
``scenes/cornell-box.pbrt`` (its spatial light grid included) and
``scenes/testball-matte.pbrt`` (a sphere, a checkerboard) and renders one
sample of each, renders the three scenes of tools/texture_work.py (every
texture class, bump maps, the Fourier BSDF: core/noise.py,
core/interpolation.py, ops/fourier.py and the per-texture lookups) at 8^2,
then checks that neither ``jax`` nor the JAX package was ever imported."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import pkgutil, sys, importlib
import torch
torch.set_num_threads(1)
import rustracer_tpu_torch
for m in pkgutil.walk_packages(rustracer_tpu_torch.__path__, "rustracer_tpu_torch."):
    importlib.import_module(m.name)
from rustracer_tpu_torch.scenes import build_dragon, build_dragon_matte
from rustracer_tpu_torch.render.renderer import Renderer, RenderConfig
for build in (build_dragon_matte, build_dragon):
    ctx, cam, film, samp, integ, _ = build(sub=1, res=(8, 8), spp=1,
                                           device="cpu")
    img = Renderer(integ.li, cam, film, samp, RenderConfig(max_lanes=64),
                   device="cpu").render(ctx)
    assert bool(torch.isfinite(img).all())
from rustracer_tpu_torch.parallel.mesh import make_train_step
from rustracer_tpu_torch.scenes import build_cornell
from rustracer_tpu_torch.tools.bench_fwdbwd import cornell_loss, value_and_grad
ctx, cam, film, samp, integ, _ = build_dragon(sub=1, res=(8, 8), device="cpu")
step = make_train_step(integ.li, cam, film, samp, device="cpu")
ctx, loss = step(ctx, torch.zeros(8, 8, 3))
assert bool(torch.isfinite(loss))
ctx, cam, film, samp, integ = build_cornell(res=(8, 8), spp=4, max_depth=3,
                                            imagemap_walls=(1, 2),
                                            device="cpu")
ctx, loss = make_train_step(integ.li, cam, film, samp, device="cpu")(
    ctx, torch.zeros(8, 8, 3))
loss, grads = value_and_grad(cornell_loss(ctx, cam, film, samp, integ),
                             ctx.textures)
assert all(bool(torch.isfinite(g).all()) for g in grads) and float(loss) > 0
import tempfile
import torch.distributed as dist
from rustracer_tpu_torch.parallel.launch import init_rank
from rustracer_tpu_torch.parallel.mesh import (make_device_mesh,
                                               make_sharded_train_step,
                                               render_sharded, sample_lanes)
init_rank(0, 1, "file://" + tempfile.mkdtemp() + "/rendezvous", device="cpu",
          timeout=60)
mesh = make_device_mesh(device="cpu")
img = render_sharded(ctx, integ.li, cam, film, samp, mesh, sample_stop=1)
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
ctx, loss = make_sharded_train_step(integ.li, cam, film, samp, mesh)(
    ctx, torch.zeros(8, 8, 3), *sample_lanes(film))
assert bool(torch.isfinite(loss))
dist.destroy_process_group()
from rustracer_tpu_torch.scene.api import parse_scene
bundle = parse_scene("scenes/cornell-box.pbrt", device="cpu").scene
assert bundle.light_grid is not None
img = bundle.render(sample_stop=1)
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
bundle = parse_scene("scenes/testball-matte.pbrt", device="cpu").scene
assert bundle.geom.has_quadrics
img = bundle.render(sample_stop=1)
assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
import tempfile
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.tools.texture_work import TEXTURE_SCENES, scene_text
for name in TEXTURE_SCENES:
    text = scene_text(name, res=8, spp=1, bsdf_dir=tempfile.mkdtemp())
    img = parse_scene_string(text, device="cpu").scene.render()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0, name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "rustracer_tpu."))
             or m == "rustracer_tpu")
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
