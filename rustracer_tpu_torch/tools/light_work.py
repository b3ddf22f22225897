"""Inputs and bounds of the lights' hand kernels: K15 (an infinite light's
sample), K16 (the escaped rays' sky) and K12's branches for point,
distant, quadric area and infinite lights; shared by chip_smoke.py and the
tests.

- ``MIXED_SCENE``: a scene of every light type (a point light, a distant
  light, a triangle light, a full sphere, a clipped and rotated two-sided
  sphere, a disk with an inner radius and a clipped cylinder as area
  lights, the sky EXR and a map of ones as infinite lights) over matte
  quads and a sphere; its textures are found in ``SCENES``; ``light_scene``
  keeps some of its lights and drops the others.
- ``k15_work``, ``k16_work``, ``k12_light_work``: a call's bytes (each
  input read once, each output written once) and operations, counted on
  its data (chip_smoke.py's ``bound`` turns them into the least time on
  one H100).
- ``capture_light_step``: every K15 and K16 call of one renderer step.

Operations are float32 operations at one each (a divide, a square root,
compares and selects included), CUDA's sinf, cosf and acosf at SIN_OPS and
atan2f at ATAN2_OPS (a polynomial with its range reduction), counted from
csrc/lights.cuh.
"""
from __future__ import annotations

import contextlib
import os

from .quadric_work import ATAN2_OPS, record_calls

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")
SIN_OPS = 20
# Distribution2D.sample_continuous: two bisections (about 4 operations a
# step, log2(H + 1) and log2(W + 1) steps) and two Distribution1D
# inversions of 9 operations, the pdf's product
SAMPLE_1D_OPS = 9
BISECT_STEP_OPS = 4
# uv -> direction: 3 products, sinf and cosf of theta and of phi, 2
# products, rows 0-2 of l2w (9 products, 6 sums)
UV_TO_DIR_OPS = 3 + 4 * SIN_OPS + 2 + 15
# direction -> uv: rows 0-2 of w2l 15, the normalisation 11, the clamp 2,
# acosf, atan2f, the wrap 2, 2 divides, sinf
DIR_TO_UV_OPS = 15 + 11 + 2 + SIN_OPS + ATAN2_OPS + 2 + 2 + SIN_OPS
# the bilinear REPEAT lookup: the texel coordinates 10, four texels'
# wrapped indices 24, four weights 6, 12 products and 9 sums
BILERP_OPS = 10 + 24 + 6 + 21
# the pdf over sin theta (a compare, a product, a max, a divide)
INF_PDF_OPS = 4
# K15 an infinite lane beyond the sample: Le (3 products), the target (7)
K15_TAIL_OPS = 3 + 7
# K16 a lane and light after a bounce: the map pdf's texel 12, the pmf's
# product, the power heuristic 6, the weight's select and 3 products, the
# sum's 3 adds
K16_MIS_OPS = 12 + INF_PDF_OPS + 1 + 6 + 1 + 3 + 3
# K12 a probe: a point light (the probe point 3, d 3, dist2 6, the 3
# divides, y 5, the contribution 4, the sum 1); a triangle light as the
# triangle kernel counts it (scene/lightdistrib.py K12_PROBE_OPS); an area
# light on a quadric (the probe point 3, d 3, dist2 6, wi 6, cos 8, facing
# 3, the pdf 4, two selects, the contribution 4, the sum 1), and for a
# full sphere seen from outside the cone besides (its geometry 22, the sample's cosines
# and distances 30, the frame 20, the point and normal with sinf and cosf
# of phi 2 SIN_OPS + 30, its pdf 4)
K12_POINT_OPS = 25
K12_AREA_OPS = 40
K12_CONE_OPS = 22 + 30 + 20 + 2 * SIN_OPS + 30 + 4
# a distant or infinite light's probe contribution, once a grid: its
# sample (an infinite light's inversion, uv -> sin theta, Le), y and the
# contribution, and the sum over the probes
K12_DISTANT_OPS = 5 + 4 + 1

# MIXED_SCENE in segments: its light directives under the names
# ``light_scene`` takes, the rest (camera, film, the matte quads and
# sphere) under None
MIXED_SEGMENTS = (
    (None, '''LookAt 0 1.5 -5  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "02sequence" "integer pixelsamples" [2]
Film "image" "integer xresolution" [32] "integer yresolution" [24]
Integrator "path" "integer maxdepth" [3]
  "string lightsamplestrategy" "uniform"
WorldBegin
'''),
    ("point", '''LightSource "point" "rgb I" [3 2 1] "point from" [1 2.5 -1]
'''),
    ("distant", '''AttributeBegin
  Rotate 30 0 1 0
  LightSource "distant" "rgb L" [0.8 0.9 1.0] "point from" [1 3 -2]
    "point to" [0 0 0]
AttributeEnd
'''),
    ("infinite", '''AttributeBegin
  Rotate 90 1 0 0
  LightSource "infinite" "string mapname" "textures/sky.exr"
    "rgb L" [0.5 0.5 0.6]
AttributeEnd
'''),
    ("infinite ones", '''LightSource "infinite" "rgb L" [0.05 0.04 0.03] "integer nsamples" [2]
'''),
    (None, '''Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 3  4 0 3  4 4 3  -4 4 3]
'''),
    ("triangle", '''AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 5 4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]
AttributeEnd
'''),
    ("full sphere (cone)", '''AttributeBegin
  Material "matte" "rgb Kd" [0 0 0]
  AreaLightSource "diffuse" "rgb L" [9 9 8]
  Translate -2 1 0.5
  Shape "sphere" "float radius" [0.3]
AttributeEnd
'''),
    ("clipped sphere", '''AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 6 8] "bool twosided" "true"
  Translate 2 1.2 0.5
  Rotate 40 1 0 0
  Shape "sphere" "float radius" [0.4] "float zmin" [-0.2] "float zmax" [0.3]
    "float phimax" [270]
AttributeEnd
'''),
    ("disk", '''AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Translate 0 2.2 1.5
  Rotate 90 1 0 0
  Shape "disk" "float radius" [0.5] "float innerradius" [0.1]
    "float height" [0.05]
AttributeEnd
'''),
    ("cylinder", '''AttributeBegin
  AreaLightSource "diffuse" "rgb L" [3 4 5]
  Translate 1 0.2 -1.5
  Rotate -90 1 0 0
  Shape "cylinder" "float radius" [0.15] "float zmin" [0] "float zmax" [0.6]
    "float phimax" [300]
AttributeEnd
'''),
    (None, '''Material "matte" "rgb Kd" [0.7 0.3 0.2]
AttributeBegin
  Translate 0 0.5 0
  Shape "sphere" "float radius" [0.5]
AttributeEnd
WorldEnd
'''),
)
MIXED_LIGHTS = tuple(k for k, _ in MIXED_SEGMENTS if k is not None)


def light_scene(*names) -> str:
    """MIXED_SCENE with the light directives of ``names`` (of
    MIXED_LIGHTS) alone, and all of its other shapes."""
    unknown = set(names) - set(MIXED_LIGHTS)
    if unknown:
        raise ValueError(f"no light {sorted(unknown)} in MIXED_SCENE")
    return "".join(text for k, text in MIXED_SEGMENTS
                   if k is None or k in names)


MIXED_SCENE = light_scene(*MIXED_LIGHTS)
# MIXED_SCENE's light rows: point and distant lights, the quadric area
# lights, the triangle lights, the infinite lights last
MIXED_ROWS = {"point": [0], "distant": [1], "full sphere (cone)": [2],
              "clipped sphere": [3], "disk": [4], "cylinder": [5],
              "triangle": [6, 7], "two infinite": [8, 9]}


def _log2_steps(n):
    return max(1, (int(n) - 1).bit_length())


def _inf_sample_ops(h, w):
    return (BISECT_STEP_OPS * (_log2_steps(h + 1) + _log2_steps(w + 1))
            + 2 * SAMPLE_1D_OPS + 1 + UV_TO_DIR_OPS + INF_PDF_OPS
            + BILERP_OPS)


def _table_bytes(lt, k):
    """Bytes of infinite light k's map and distribution in the flat
    table."""
    h, w = lt.inf_maps[k].shape[:2]
    return 4 * (h * w * 3 + h * w + h * (w + 1) + h + h + h + 1 + 1)


def k15_work(lt, lid) -> dict:
    """K15 on light rows ``lid`` (B,): every lane's id, point and u in and
    its four outputs (wi, pdf, li, target) out, each infinite light's
    tables once; an infinite lane's sample, Le and target."""
    n = lid.shape[0]
    moved = n * (4 + 12 + 8 + 12 + 4 + 12 + 12)
    ops, lanes = 0, 0
    for k, row in enumerate(lt.inf_rows):
        m = int((lid == row).sum())
        h, w = lt.inf_maps[k].shape[:2]
        lanes += m
        ops += m * (_inf_sample_ops(h, w) + K15_TAIL_OPS)
        moved += _table_bytes(lt, k) if m else 0
    return dict(lanes=n, infinite_lanes=lanes, moved=moved, ops=ops)


def k16_work(lt, mask, mis: bool) -> dict:
    """K16 on escaped lanes ``mask`` (B,): every lane's direction and mask
    in (after a bounce also its pdf, specular flag and one pmf a light)
    and its radiance out, the tables once; an escaped lane's uv, Le and
    (after a bounce) MIS weight for each infinite light."""
    n, k = mask.shape[0], lt.n_infinite
    m = int(mask.sum())
    moved = n * (12 + 1 + 12 + ((4 + 1 + 4 * k) if mis else 0)) \
        + sum(_table_bytes(lt, j) for j in range(k))
    per = DIR_TO_UV_OPS + BILERP_OPS + 3 + (K16_MIS_OPS if mis else 3)
    return dict(lanes=n, escaped=m, moved=moved, ops=m * k * per)


def k12_light_work(lt, j, n_vox, n_probes, cone_probes=0) -> dict:
    """K12's branch for light row ``j`` over a grid of ``n_vox`` voxels:
    its column out (a float a voxel) and its table row in; a point,
    triangle or quadric light's operations every (voxel, probe), a
    triangle's as the triangle kernel's (scene/lightdistrib.py
    K12_PROBE_OPS), ``cone_probes`` of a quadric's through the cone; a
    distant or infinite light's contribution depends on the probe alone,
    computed once a grid."""
    from ..scene.lightdistrib import K12_PROBE_OPS
    from ..scene.lights import (LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE,
                                LIGHT_POINT)
    t = int(lt.l_type[j])
    moved = n_vox * 4 + 4 * (1 + 3 + 3 + 1 + 1 + 9 + 1 + 1 + 16 + 16 + 4
                             + 1 + 1 + 1)
    pairs = n_vox * n_probes
    if t == LIGHT_POINT:
        ops = pairs * K12_POINT_OPS
    elif t == LIGHT_AREA and int(lt.l_q_type[j]) < 0:
        ops = pairs * K12_PROBE_OPS
    elif t == LIGHT_AREA:
        ops = pairs * K12_AREA_OPS + cone_probes * K12_CONE_OPS
    elif t == LIGHT_DISTANT:
        ops = n_probes * K12_DISTANT_OPS
    elif t == LIGHT_INFINITE:
        k = int(lt.row_inf[j])
        h, w = lt.inf_maps[k].shape[:2]
        moved += _table_bytes(lt, k)
        ops = n_probes * (_inf_sample_ops(h, w) + K12_DISTANT_OPS)
    else:
        ops = 0
    return dict(moved=moved, ops=ops)


def capture_light_step(renderer, ctx, tile, sample=1) -> dict:
    """One step of ``tile`` at ``sample`` -> the arguments of every call of
    scene/lights.py ``infinite_sample`` (K15: lt, lid, p, u; one a NEE) and
    ``infinite_escape`` (K16: lt, d, mask[, prev_pdf, prev_spec, pmfs]; one
    a bounce, the camera rays' first), in order, under those names."""
    from ..scene import lights   # the module whose functions are wrapped
    calls = {}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with contextlib.ExitStack() as stack:
        for name in ("infinite_sample", "infinite_escape"):
            stack.enter_context(record_calls(lights, name, calls, True))
        renderer.step(ctx, fs, px, py, sample, v)
    return calls
