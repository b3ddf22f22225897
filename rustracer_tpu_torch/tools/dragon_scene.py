"""The benchmark dragon as a PBRT scene file: ``scenes.py``'s
``build_dragon`` written out so that the parser reproduces its tables.

``write_dragon_scene(directory)`` writes three files: ``dragon.ply`` (the
hero mesh of ``dragon_tris(sub)``: positions, normals and the spherical uv,
binary), ``hero.exr`` (level 0 of the hero texture, float32, so no gamma
applies) and ``dragon.pbrt``, whose shapes come in the order of
``dragon_tris``'s tables (the hero plymesh, the ground, the two-triangle
light), with LookAt 0 1.1 -3.4 -> origin, fov 42, the 02sequence sampler
at 64 spp, path tracing to depth 5 and ``rgb L [18 18 18]``. With
``strategy="uniform"`` the parsed scene's vertex, index and wide-BVH tables
are ``build_dragon``'s bit for bit (its material ids differ: the hero is
material 0 here, 1 there); with the default ``"spatial"`` it picks lights
through the spatial grid.
"""
from __future__ import annotations

import os

from ..render.imageio import write_exr
from ..scenes import DRAGON_SPP, MAX_DEPTH, dragon_tris, hero_texture
from ..utils.plyio import write_ply

SCENE = """# the benchmark dragon (rustracer_tpu_torch/scenes.py build_dragon)
LookAt 0 1.1 -3.4  0 0 0  0 1 0
Camera "perspective" "float fov" [42]
Sampler "02sequence" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [{w}] "integer yresolution" [{h}]
Integrator "path" "integer maxdepth" [{depth}]{strategy}
WorldBegin
Texture "hero" "spectrum" "imagemap" "string filename" "hero.exr"
AttributeBegin
  Material "matte" "texture Kd" "hero"
  Shape "plymesh" "string filename" "dragon.ply"
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.6 0.6]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-12 -1.25 -12  12 -1.25 -12  12 -1.25 12  -12 -1.25 12]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [18 18 18]
  Material "matte" "rgb Kd" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]
AttributeEnd
WorldEnd
"""


def write_dragon_scene(directory, sub=7, res=(1024, 1024),
                       strategy="spatial"):
    """Write dragon.ply, hero.exr and dragon.pbrt into ``directory``;
    -> the path of dragon.pbrt."""
    os.makedirs(directory, exist_ok=True)
    tris, n_mesh = dragon_tris(sub)
    n_v = tris["tv_p"].shape[0] - 8      # the ground's and light's follow
    write_ply(os.path.join(directory, "dragon.ply"), tris["tv_p"][:n_v],
              tris["t_idx"][:n_mesh], n=tris["tv_n"][:n_v],
              uv=tris["tv_uv"][:n_v])
    images, _ = hero_texture()
    write_exr(os.path.join(directory, "hero.exr"), images[0][0])
    path = os.path.join(directory, "dragon.pbrt")
    with open(path, "w") as f:
        f.write(SCENE.format(
            spp=DRAGON_SPP, w=res[0], h=res[1], depth=MAX_DEPTH,
            strategy="" if strategy == "spatial" else
            f'\n  "string lightsamplestrategy" "{strategy}"'))
    return path

