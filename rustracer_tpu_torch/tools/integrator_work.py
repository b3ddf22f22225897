"""The scenes of the direct-lighting, Whitted, ambient-occlusion and normal
integrators (integrators/direct.py, whitted.py, ao.py, normal.py), shared
by chip_smoke.py and the tests.

``scene_text(name, integrator, res, spp)`` is a scene file of ``scenes/``
with its Integrator line replaced by ``INTEGRATORS[integrator]`` and its
film and sample count set; ``veach-mis`` under the direct-lighting
integrator gives its four lights the sample counts ``VEACH_NSAMPLES`` (the
area lights' "nsamples"), so that the strategy "all" averages a light's
own samples. ``CASES`` are the renders the chip phase and the parity test
make: the Cornell box under each integrator, testball-glass under
Whitted (both specular branches, 2^depth - 1 nodes) and veach-mis under
direct lighting with those counts.
"""
from __future__ import annotations

import os
import re

from .light_work import SCENES

INTEGRATORS = {
    "directlighting": 'Integrator "directlighting" "integer maxdepth" [5]',
    "directlighting-one": 'Integrator "directlighting" "string strategy" '
    '"one" "integer maxdepth" [5]',
    "whitted": 'Integrator "whitted" "integer maxdepth" [5]',
    "ao": 'Integrator "ao" "integer nsamples" [4]',
    "ambientocclusion": 'Integrator "ambientocclusion" "integer nsamples" '
    '[4]',
    "normal": 'Integrator "normal"',
}
VEACH_NSAMPLES = (1, 2, 3, 4)
# (scene, integrator) of each render
CASES = [("cornell-box", k) for k in ("directlighting", "directlighting-one",
                                      "whitted", "ao", "normal")] + [
    ("testball-glass", "whitted"), ("veach-mis", "directlighting")]


def scene_text(name, integrator, res=None, spp=None) -> str:
    """``scenes/<name>.pbrt`` under ``INTEGRATORS[integrator]``, its film
    ``res`` (width, height) and ``spp`` samples where given (its own
    otherwise), its texture files named by absolute paths."""
    with open(os.path.join(SCENES, f"{name}.pbrt")) as f:
        text = f.read()
    text = re.sub(r'"(textures/[^"]+)"',
                  lambda m: f'"{os.path.join(SCENES, m.group(1))}"', text)
    text, n = re.subn(r'Integrator "path"[^\n]*', INTEGRATORS[integrator],
                      text)
    if n != 1:
        raise ValueError(f"{name}: no single path Integrator line")
    if res is not None:
        text = re.sub(r'"integer xresolution" \[\s*\d+\s*\]',
                      f'"integer xresolution" [{res[0]}]', text)
        text = re.sub(r'"integer yresolution" \[\s*\d+\s*\]',
                      f'"integer yresolution" [{res[1]}]', text)
    if spp is not None:
        text = re.sub(r'"integer pixelsamples" \[\s*\d+\s*\]',
                      f'"integer pixelsamples" [{spp}]', text)
    if name == "veach-mis" and integrator.startswith("directlighting"):
        counts = iter(VEACH_NSAMPLES)
        text = re.sub(r'(AreaLightSource "diffuse"[^\n]*)',
                      lambda m: f'{m.group(1)} "integer nsamples" '
                                f'[{next(counts)}]', text)
    return text
