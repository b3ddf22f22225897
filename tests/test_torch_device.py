"""The port's entry points run on the card unless the caller asks for the
CPU: each defaults to ``device="cuda"``, and the dragon built without a
``device`` on a machine without CUDA raises instead of running on the CPU."""
import inspect

import pytest
import torch

from rustracer_tpu_torch import convert, scenes
from rustracer_tpu_torch.parallel.mesh import make_train_step
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.renderer import Renderer
from rustracer_tpu_torch.scene.lights import make_lights
from rustracer_tpu_torch.scene.tables import make_geometry

ENTRY_POINTS = (scenes.dragon_geometry, scenes.build_dragon_matte,
                scenes.build_dragon, Renderer, make_geometry, make_lights,
                Film.init_state, convert.geometry_from_jax,
                convert.lights_from_jax, convert.textures_from_jax,
                scenes.build_cornell, scenes.cornell_box, make_train_step)


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("build", [scenes.build_dragon_matte,
                                   scenes.build_dragon])
def test_no_cpu_fallback_without_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        build(sub=1, res=(8, 8), spp=1)
