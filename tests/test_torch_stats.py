"""The port's counters (utils/stats.py, the renderer's device tape, the path
integrator's observed tests, the texture lookups' counts, the scene
build's counters) against the JAX package's on the same scenes, parsed and
rendered by both: tests/test_stats.py's SCENE (24 x 16, 4 spp, path depth
4: a point light over a floor and a sphere), where every Scene/, BVH/,
Integrator/ and Intersections/ entry must be equal, the observed counts
included, and a small textured scene (compaction off at its width: every
lookup runs on the wavefront's lanes in both packages), where the
Textures/ entries must be equal. The JAX package's MaterialSet._n_rows
infers a material's lobe rows by evaluating it on one dummy lane while the
step is traced, and its image textures add that lane to the counters: a
lookup the render never runs, which the port does not make. The JAX
counts the port is held to leave those probes out (``_without_probes``).

The BVH/ entries count the port's 16-wide tree, under names of its own
(the JAX package's count its binary tree): on scenes of more than 8
triangles, one of them instanced, they must equal the counts of the
BVH build's own node lists (accel/bvh_build.py), and every triangle must lie
in one leaf record.

Tolerance: equal integers."""
import io
import itertools
import os

import numpy as np
import pytest
import torch

from rustracer_tpu.scene.api import parse_scene_string as jax_parse_string
from rustracer_tpu.utils import stats as JS
from rustracer_tpu_torch.accel import bvh_build as BB
from rustracer_tpu_torch.scene.api import parse_scene_string
from rustracer_tpu_torch.utils import stats as PS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "scenes", "textures", "grid.png")

SCENE = """
Film "image" "integer xresolution" [24] "integer yresolution" [16]
LookAt 0 0.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
Sampler "02sequence" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [4]
WorldBegin
  LightSource "point" "rgb I" [10 10 10] "point from" [0 2 -1]
  AttributeBegin
    Material "matte" "rgb Kd" [0.6 0.6 0.6]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
  AttributeEnd
  Shape "sphere" "float radius" [0.5]
WorldEnd
"""

# a floor under an atlas imagemap (the shared-atlas EWA lookup), a card
# under a trilinear imagemap and one under an imagemap of anisotropy 16
# (per-texture lookups), lit by a point light; path depth 2
TEXTURED = f"""
Film "image" "integer xresolution" [20] "integer yresolution" [12]
LookAt 0 1.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
Sampler "02sequence" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
WorldBegin
  LightSource "point" "rgb I" [20 20 20] "point from" [0 3 -1]
  Texture "g" "spectrum" "imagemap" "string filename" "{GRID}"
  Texture "t" "spectrum" "imagemap" "string filename" "{GRID}"
    "bool trilinear" "true"
  Texture "e" "spectrum" "imagemap" "string filename" "{GRID}"
    "float maxanisotropy" [16]
  AttributeBegin
    Material "matte" "texture Kd" "g"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
      "float uv" [0 0 4 0 4 4 0 4]
  AttributeEnd
  AttributeBegin
    Material "plastic" "texture Kd" "t"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-2 -1 1  0 -1 1  0 1 1  -2 1 1]
      "float uv" [0 0 1 0 1 1 0 1]
  AttributeEnd
  AttributeBegin
    Material "matte" "texture Kd" "e"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [0.2 -1 1  2 -1 2  2 1 2  0.2 1 1]
      "float uv" [0 0 1 0 1 1 0 1]
  AttributeEnd
WorldEnd
"""


def _registry(S):
    return {"counters": dict(S._counters), "memory": dict(S._memory),
            "distributions": dict(S._distributions),
            "percents": dict(S._percents), "ratios": dict(S._ratios)}


def _entries(reg, cats):
    """Every non-empty entry of ``reg`` in categories ``cats``."""
    out = {}
    for kind, d in reg.items():
        for name, v in d.items():
            if name.split("/", 1)[0] in cats and v not in (0, (0, 0)):
                out[(kind, name)] = v
    return out


def _without_probes(monkeypatch):
    """Leave the JAX package's one-lane structure probes
    (MaterialSet._n_rows) out of its device counters."""
    from rustracer_tpu.scene.materials import MaterialSet
    probe = [0]
    n_rows, count = MaterialSet._n_rows, JS.device_count

    def n_rows_quiet(m):
        probe[0] += 1
        try:
            return n_rows(m)
        finally:
            probe[0] -= 1

    def count_outside_probes(name, value):
        if not probe[0]:
            count(name, value)
    monkeypatch.setattr(MaterialSet, "_n_rows", staticmethod(n_rows_quiet))
    monkeypatch.setattr(JS, "device_count", count_outside_probes)


def _render_both(text):
    """-> (the JAX package's registry, the port's, their printed tables)
    after parsing and rendering ``text`` in each."""
    JS.init_stats()
    img = np.asarray(jax_parse_string(text).scene.render())
    assert np.isfinite(img).all()
    PS.init_stats()
    pimg = parse_scene_string(text, device="cpu").scene.render()
    assert torch.isfinite(pimg).all()
    tables = []
    for S in (JS, PS):
        buf = io.StringIO()
        S.print_stats(buf)
        tables.append(buf.getvalue())
    return _registry(JS), _registry(PS), tables


@pytest.fixture(scope="module")
def scene_stats():
    return _render_both(SCENE)


def test_counters_equal_the_jax_package(scene_stats):
    jreg, preg, _ = scene_stats
    cats = ("Scene", "BVH", "Integrator", "Intersections")
    want, got = _entries(jreg, cats), _entries(preg, cats)
    assert got == want
    cam = 24 * 16 * 4
    assert got[("counters", "Integrator/Camera rays traced")] == cam
    obs = got[("counters", "Intersections/Regular ray intersection tests "
               "(observed)")]
    assert cam <= obs < cam * 4
    assert got[("counters", "Intersections/Shadow ray intersection tests "
                "(observed)")] > 0


def test_memory_and_table(scene_stats):
    jreg, preg, (jtab, ptab) = scene_stats
    assert preg["memory"]["Memory/Film pixels"] == \
        jreg["memory"]["Memory/Film pixels"] == 24 * 16 * 16
    assert preg["memory"].keys() == {"Memory/Film pixels",
                                     "Memory/Triangle meshes"}
    assert all(v > 0 for v in preg["memory"].values())

    def cats(tab):
        return [line for line in tab.splitlines()
                if line.startswith("  ") and not line.startswith("    ")]
    assert cats(ptab) == cats(jtab) == ["  Integrator", "  Intersections",
                                        "  Memory", "  Scene"]
    assert ptab.startswith("Statistics:\n")
    assert "Camera rays traced" in ptab


def test_texture_lookups_equal_the_jax_package(monkeypatch):
    _without_probes(monkeypatch)
    jreg, preg, _ = _render_both(TEXTURED)
    want = _entries(jreg, ("Textures",))
    assert {k[1] for k in want} == {"Textures/EWA lookups",
                                    "Textures/Trilinear lookups"}
    assert _entries(preg, ("Textures",)) == want
    assert preg["memory"]["Memory/Texture MIP maps"] > 0


# tests/test_stats.py's BVH scene: SCENE with its sphere replaced by nine
# quads on a grid (20 triangles)
GRID_QUADS = "".join(f"""
  AttributeBegin
    Translate {x} 0 {z}
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [0 0 0  0.5 0 0  0.5 0 0.5  0 0 0.5]
  AttributeEnd""" for x, z in itertools.product(range(3), range(3)))
MESH = SCENE.replace('  Shape "sphere" "float radius" [0.5]\n',
                     GRID_QUADS + "\n")
# the same 20 static triangles, and an object of three quads (6
# triangles) placed three times
OBJECT = """
  ObjectBegin "strip"
""" + "".join(f"""
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [{x} 0 0  {x + 0.4} 0 0  {x + 0.4} 0.4 0  {x} 0.4 0]"""
              for x in (0.0, 0.5, 1.0)) + """
  ObjectEnd
""" + "".join(f"""
  TransformBegin
    Translate {x} 1 2
    ObjectInstance "strip"
  TransformEnd""" for x in (-2, 0, 2))
INSTANCED = MESH.replace("WorldBegin\n", "WorldBegin\n" + OBJECT + "\n")


def _wide_lists(lo, hi, max_prims):
    """The BVH build's node lists of one tree -> (interior nodes, leaves)."""
    _, _, meta, _ = BB.build_binary_sah(lo, hi, max_prims)
    wc, wl, _, _ = BB._collapse_or_wrap(meta)
    return len(wc), len(BB._collect_leaves(wc, wl)[1])


def _expected_tree(geom, n_static):
    """The 16-wide tree's interior nodes and leaf records, counted from
    the BVH build's node lists over the scene's triangles (rows [0,
    n_static) static; the rest one object, entered through each row of
    inst_o2w): a plain scene is one tree; an instanced one is a root over
    the static tree and the instance tree, and the object's tree once."""
    tv_p, t_idx = geom.tv_p.numpy(), geom.t_idx.numpy()
    if not geom.has_instances:
        return _wide_lists(*BB.triangle_bounds(tv_p, t_idx), BB.LEAF_K)
    s_int, s_leaf = _wide_lists(*BB.triangle_bounds(tv_p, t_idx[:n_static]),
                                BB.LEAF_K)
    olo, ohi = BB.triangle_bounds(tv_p, t_idx[n_static:])
    nl, nh, _, _ = BB.build_binary_sah(olo, ohi, BB.LEAF_K)
    o_int, o_leaf = _wide_lists(olo, ohi, BB.LEAF_K)
    boxes = [BB.xform_aabb(m, nl[0], nh[0]) for m in geom.inst_o2w.numpy()]
    i_int, _ = _wide_lists(np.stack([b[0] for b in boxes]),
                           np.stack([b[1] for b in boxes]), 1)
    return 1 + s_int + i_int + o_int, s_leaf + o_leaf


@pytest.mark.parametrize("name", ["mesh", "instanced"])
def test_bvh_entries_count_the_16_wide_tree(name):
    PS.init_stats()
    text = {"mesh": MESH, "instanced": INSTANCED}[name]
    geom = parse_scene_string(text, device="cpu").scene.geom
    assert geom.n_triangles == {"mesh": 20, "instanced": 26}[name]
    assert geom.has_instances == (name == "instanced")
    if name == "instanced":
        assert geom.inst_o2w.shape[0] == 3
    interiors, leaves = _expected_tree(geom, 20)
    c, r = PS._counters, PS._ratios
    assert c["BVH/16-wide interior nodes"] == interiors
    assert c["BVH/16-wide leaf records"] == leaves
    assert r["BVH/Triangles per 16-wide leaf"] == (
        c["Scene/Triangles"], leaves)
    assert c["Scene/Triangles"] == geom.n_triangles
    assert PS._memory["Memory/BVH tree"] > 0
    buf = io.StringIO()
    PS.print_stats(buf)
    table = buf.getvalue()
    for title in ("16-wide interior nodes", "16-wide leaf records",
                  "Triangles per 16-wide leaf"):
        assert f"    {title}" in table
    # the JAX package's names (its binary tree) are not the port's
    assert not any(k in c for k in ("BVH/Interior nodes", "BVH/Leaf nodes"))


def test_device_tape_folds_each_step():
    """The tape's sums, minima and maxima over steps whose sequences of
    names differ, host ints beside 0-d tensors: those of the values
    added, fetched in one transfer."""
    tape = PS.DeviceTape()
    want = {"a": 0, "b": 0, "h": 0}
    lo, hi = None, None
    for step, names in enumerate((("a", "b"), ("a",), ("a", "b"),
                                  ("b", "a", "a"))):
        for i, n in enumerate(names):
            tape.add(n, torch.tensor(step * 10 + i))
            want[n] += step * 10 + i
        tape.add("h", step)
        want["h"] += step
        tape.min("len", torch.tensor(7 - step))
        tape.max("len", torch.tensor(3 * step))
        lo = 7 - step if lo is None else min(lo, 7 - step)
        hi = 3 * step if hi is None else max(hi, 3 * step)
        tape.end_step()
    tape.add("a", torch.tensor(100))   # after the last step: fetch folds it
    want["a"] += 100
    sums, mins, maxs = tape.fetch()
    assert sums == want and all(isinstance(v, int) for v in sums.values())
    assert mins == {"len": lo} and maxs == {"len": hi}
