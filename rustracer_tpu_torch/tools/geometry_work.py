"""The geometry scenes and the inputs and bounds of K1's instanced and alpha
walks and K2's instance branch; shared by chip_smoke.py and the tests.

- ``GEOMETRY_SCENES``: scenes on testball-matte's stage (its camera, light,
  checkerboard floor and matte ball). ``alpha-cards`` holds two objects,
  ``card`` (a unit quad whose float imagemap ``alpha`` is a checkerboard
  image, ``write_checker``) and ``card-shadow`` (the same with an imagemap
  ``shadowalpha`` of ``scenes/textures/grid.png`` too), placed by
  ``N_CARDS`` ``ObjectInstance``s at seeded rotations around the ball, a
  ``Material "none"`` sphere around the ball (a medium interface) and
  ``Accelerator "bvh" "string splitmethod" "middle"``;
  ``alpha-cards-static`` is the same scene with each card written out as
  its own mesh (no instance: the alpha walk without instances) under
  ``Accelerator "hlbvh"`` (built as SAH, as the reference builds it).
  ``scene_text`` formats one at a film size and sample count, its
  checkerboard image written into ``tex_dir``. (The reference has no float
  checkerboard texture, so the checkerboard is an image.)
- ``k1_work``: the work of a K1 call, counted by the plain walk through
  read-counting views of the record table and the alpha tables (the rows,
  triangle tests, instance entries, alpha lookups and the distinct records,
  triangles and texels read); ``k1_bound`` turns it into the least time on
  one H100, ``k2_inst_work`` the same for K2's instance branch.
- ``capture_geometry_step``: every K1 (``traverse16``) and K2
  (``build_interaction``) call of one renderer step; ``compare_k1`` holds a
  K1 call against its plain twin bit for bit.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..accel.bvh_build import TAG_INST
from ..accel.traverse16 import alpha_tables, traverse16, traverse16_plain
from ..core.ray import Ray
from .light_work import SCENES
from .traverse_work import (PEAK_BYTES_PER_S, PEAK_OPS_PER_S, RAY_BYTES,
                            SLAB_OPS, TRI_OPS, _CountedTable)

GRID = os.path.join(SCENES, "textures", "grid.png")
CHECKER = "alpha-checker.png"
N_CARDS = 32
# operations of one instance entry (the origin by three rows of the w2o,
# 18; the direction, 15; three inverse directions with their range tests,
# 9; the octant, 3) and of one alpha lookup (the uv from the barycentrics,
# 10; the bilinear lookup: the scaled and floored coordinates, their
# fractions and integers, 12, four wraps and texel indices, 16, the
# weighted sum, 15; the compare, 1)
INST_OPS = 45
UV_OPS = 10
BILERP_OPS = 44
# K2's instance branch a lane: three vertices through o2w with the divide
# by w (28 each) and three normals through the inverse's columns (15 each)
K2_INST_OPS = 3 * 28 + 3 * 15
# bytes a K1 call of the instanced walk writes more a ray (the instance)
INST_BYTES = 4

_STAGE = '''LookAt 0 1.7 -4.4   0 0.7 0   0 1 0
Camera "perspective" "float fov" [32]
Sampler "02sequence" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Integrator "path" "integer maxdepth" [7]
Accelerator "bvh" "string splitmethod" "middle"
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [11 11 11]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1.6 5.2 -1.6   1.6 5.2 -1.6   1.6 5.2 1.6   -1.6 5.2 1.6]
AttributeEnd
Texture "checks" "spectrum" "checkerboard"
  "float uscale" [16] "float vscale" [16]
  "rgb tex1" [0.2 0.2 0.2] "rgb tex2" [0.75 0.75 0.75]
Material "matte" "texture Kd" "checks"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-8 0 -8   8 0 -8   8 0 8   -8 0 8]
  "float uv" [0 0  1 0  1 1  0 1]
Material "matte" "rgb Kd" [0.5 0.5 0.5]
AttributeBegin
  Translate 0 0.75 0
  Shape "sphere" "float radius" [0.75]
AttributeEnd
AttributeBegin
  Translate 0 0.75 0
  Material "none"
  Shape "sphere" "float radius" [0.95]
AttributeEnd
Texture "cut" "float" "imagemap" "string filename" "{checker}"
Texture "grid" "float" "imagemap" "string filename" "{grid}"
'''
_CARD = '''Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-0.35 -0.35 0   0.35 -0.35 0   0.35 0.35 0   -0.35 0.35 0]
  "float uv" [0 0  1 0  1 1  0 1] "texture alpha" "cut"'''
_OBJECTS = '''ObjectBegin "card"
  Material "matte" "rgb Kd" [0.7 0.35 0.2]
  {card}
ObjectEnd
ObjectBegin "card-shadow"
  Material "matte" "rgb Kd" [0.2 0.4 0.7]
  {card} "texture shadowalpha" "grid"
ObjectEnd
'''


def card_placements(n=N_CARDS, seed=5):
    """-> [(object name, transform directives)] of the n cards: a seeded
    ring of radius 1.2-2.2 around the ball at heights 0.3-1.8, each card
    turned about y and tilted; every third card is a ``card-shadow``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ang = 2 * np.pi * k / n + rng.uniform(-0.1, 0.1)
        r = rng.uniform(1.2, 2.2)
        x, z, y = r * np.cos(ang), r * np.sin(ang), rng.uniform(0.3, 1.8)
        out.append(("card-shadow" if k % 3 == 2 else "card",
                    f"Translate {x:.4f} {y:.4f} {z:.4f}\n"
                    f"Rotate {rng.uniform(0, 360):.2f} 0 1 0\n"
                    f"Rotate {rng.uniform(-40, 40):.2f} 1 0 0"))
    return out


def _cards(static: bool) -> str:
    text = "" if static else _OBJECTS.format(card=_CARD)
    for name, xform in card_placements():
        if static:
            kd = "0.2 0.4 0.7" if name == "card-shadow" else "0.7 0.35 0.2"
            extra = ' "texture shadowalpha" "grid"' \
                if name == "card-shadow" else ""
            text += (f'AttributeBegin\n{xform}\nMaterial "matte" "rgb Kd" '
                     f'[{kd}]\n{_CARD}{extra}\nAttributeEnd\n')
        else:
            text += (f'TransformBegin\n{xform}\nObjectInstance "{name}"\n'
                     'TransformEnd\n')
    return text + "WorldEnd\n"


GEOMETRY_SCENES = {
    "alpha-cards": _STAGE + _cards(static=False),
    "alpha-cards-static": _STAGE.replace(
        'Accelerator "bvh" "string splitmethod" "middle"',
        'Accelerator "hlbvh"') + _cards(static=True),
}


def write_checker(path, n=8):
    """An n x n checkerboard image of 0 and 1 (a texel a check) at
    ``path``: the cards' alpha, cut out where 0."""
    from ..render.imageio import write_image
    img = np.zeros((n, n, 3), np.float32)
    img[np.add.outer(np.arange(n), np.arange(n)) % 2 == 1] = 1.0
    write_image(path, img)
    return path


def scene_text(name, res, spp, tex_dir) -> str:
    """``GEOMETRY_SCENES[name]`` with a res^2 film and spp samples; its
    checkerboard image is written into ``tex_dir``."""
    checker = write_checker(os.path.join(tex_dir, CHECKER))
    return GEOMETRY_SCENES[name].format(res=res, spp=spp, checker=checker,
                                        grid=GRID)


# ---------------------------------------------------------------------------
# work and bounds
# ---------------------------------------------------------------------------

def k1_work(geom, ray, any_hit):
    """The plain walk (instances and alpha as ``geom`` holds them) on
    ``ray`` -> (its outputs (hit, t, prim, counts, inst), work dict: rays,
    rows read, triangle tests, interior, leaf and instance rows, distinct
    records; alpha lookups (bilerps), alpha candidates (hits whose alpha
    ids were read), distinct triangles and texels the alpha test read)."""
    table = _CountedTable(geom.bvh16_table)
    alpha = alpha_tables(geom, any_hit)
    if alpha is not None:
        t_shade, cols, atlas, meta = alpha
        alpha = (_CountedTable(t_shade), tuple(_CountedTable(c) for c in cols),
                 _CountedTable(atlas), _CountedTable(meta))
    out = traverse16_plain(table, geom.bvh16_roots, geom.bvh16_depth, ray.o,
                           ray.d, ray.t_max, any_hit, geom.has_instances,
                           alpha)
    tag = geom.bvh16_table[:, 0].view(torch.int32)
    leaf, inst = tag < 0, tag >= TAG_INST
    reads = table.reads
    work = dict(rays=ray.o.shape[0], rows=int(out[3][0]),
                tests=int(out[3][1]),
                interior_rows=int(reads[~leaf & ~inst].sum()),
                leaf_rows=int(reads[leaf].sum()),
                inst_rows=int(reads[inst].sum()),
                distinct=int((reads > 0).sum()),
                alpha_lookups=0, alpha_candidates=0, alpha_tris=0,
                alpha_texels=0)
    if alpha is not None:
        work.update(alpha_lookups=int(alpha[2].reads.sum()) // 4,
                    alpha_candidates=int(alpha[1][0].reads.sum()),
                    alpha_tris=int((alpha[0].reads > 0).sum()),
                    alpha_texels=int((alpha[2].reads > 0).sum()))
    return out, work


def k1_bound(work, n_cols=1):
    """-> (bound ms, "bytes" or "operations") of a K1 call doing ``work``:
    the rays (and their instance out), every distinct record, each alpha
    triangle's uv words and ids and each texel read once; the slab and
    triangle tests, the instance entries, the uv of each alpha candidate
    and each bilinear lookup (``n_cols`` alpha columns a triangle)."""
    moved = (work["rays"] * (RAY_BYTES + INST_BYTES) + work["distinct"] * 512
             + work["alpha_tris"] * (7 + n_cols) * 4
             + work["alpha_texels"] * 4)
    ops = (work["interior_rows"] * 16 * SLAB_OPS + work["tests"] * TRI_OPS
           + work["inst_rows"] * INST_OPS
           + work["alpha_candidates"] * UV_OPS
           + work["alpha_lookups"] * BILERP_OPS)
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def k2_inst_work(geom, hit, inst, lane_ops, lane_bytes):
    """K2's instance branch on hits ``hit`` of instances ``inst``: ->
    (bytes, ops) of the call, K2's own (``lane_ops``, ``lane_bytes`` a
    lane) plus, a lane of an instance, the transforms (K2_INST_OPS) and
    each distinct instance's two matrices and flag read once."""
    use = hit & (inst >= 0)
    n = hit.shape[0]
    distinct = int(torch.unique(inst[use]).numel())
    return (n * lane_bytes + n * 4 + distinct * (2 * 64 + 1),
            n * lane_ops + int(use.sum()) * K2_INST_OPS)


# ---------------------------------------------------------------------------
# a step's calls
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def record(module, name, into):
    """Within the scope, each call of ``module.name`` appends its
    arguments and keyword arguments (tensors and rays cloned) to
    ``into[name]``."""
    orig = getattr(module, name)

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, Ray):
            return Ray(o=x.o.clone(), d=x.d.clone(), t_max=x.t_max.clone())
        return x

    def recorded(*args, **kw):
        into.setdefault(name, []).append(
            (tuple(clone(a) for a in args),
             {k: clone(v) for k, v in kw.items()}))
        return orig(*args, **kw)

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_geometry_step(renderer, ctx, tile, sample=1) -> dict:
    """One step of ``tile`` at ``sample`` -> {"traverse16": [(args, kw)],
    "build_interaction": [(args, kw)]}: every K1 and K2 call of the step,
    in order (scene/tables.py's calls)."""
    from ..scene import tables
    calls = {}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with record(tables, "traverse16", calls), \
            record(tables, "build_interaction", calls):
        renderer.step(ctx, fs, px, py, sample, v)
    return calls


def compare_k1(args, kw):
    """A recorded traverse16 call, the kernel against its plain twin ->
    (lanes, the lanes that differ in hit, t bits, prim or inst)."""
    from .. import cuda
    kw = dict(kw, with_inst=True)
    out = traverse16(*args, **kw)
    with cuda.plain_reference():
        ref = traverse16(*args, **kw)
    h, t, p, i = out[:4]
    rh, rt, rp, ri = ref[:4]
    off = (h != rh) | (t.view(torch.int32) != rt.view(torch.int32)) | \
        (p != rp) | (i != ri)
    return h.shape[0], int(off.sum())
