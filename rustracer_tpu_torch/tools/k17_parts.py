"""Diagnostic builds of K17's lookups (csrc/mipmap.cu) in the design that
read each tap's levels and texels as they came, before the one level pair
a lane and the 16-byte footprint reads: each drops one part of the work,
so that ``tools/bench_step_kernels.py --kernels K17 --time-only`` can time
what the parts cost on a recorded textures-image step. All but ``level``
compute wrong lookups on purpose:

- ``level``: the 8-tap lookup's two levels found once a lane, not once a
  tap (the same lookups);
- ``wrap``: the REPEAT wrap (two integer remainders a coordinate) replaced
  by a clamp;
- ``loads``: each texel's value made from its address (the address
  arithmetic kept, no load);
- ``constant``: each texel a constant (no address, no load).

    python -m rustracer_tpu_torch.tools.k17_parts SRC DIR

SRC holds that design's mipmap.cu, mipmap.cuh, atlas.cuh and common.cuh
(for instance ``git show <commit>:rustracer_tpu_torch/csrc/<file>`` of a
commit before the redesign); writes DIR/<part>/ with the four files, the
part's text replaced, and prints each part's mipmap.cu.
"""
from __future__ import annotations

import os
import sys

FILES = ("mipmap.cu", "mipmap.cuh", "atlas.cuh", "common.cuh")
_TRI = ("template <int STRIDE>\n"
        "__device__ __forceinline__ Tex trilinear(const Args& g, float s, "
        "float t, float width) {\n"
        "    rt_mip::Tri tl = rt_mip::tri_levels(g.n_levels, width);\n")
_TRI_AT = ("template <int STRIDE>\n"
           "__device__ __forceinline__ Tex trilinear_at(const Args& g, "
           "rt_mip::Tri tl, float s, float t);\n"
           "template <int STRIDE>\n"
           "__device__ __forceinline__ Tex trilinear(const Args& g, float s, "
           "float t, float width) {\n"
           "    return trilinear_at<STRIDE>(g, rt_mip::tri_levels(g.n_levels, "
           "width), s, t);\n"
           "}\n"
           "template <int STRIDE>\n"
           "__device__ __forceinline__ Tex trilinear_at(const Args& g, "
           "rt_mip::Tri tl, float s, float t) {\n")
_AXES = ("    rt_mip::Axes ax = rt_mip::ewa_axes(d0s, d0t, d1s, d1t, "
         "g.max_aniso);\n")
_TAP = ("Tex v = trilinear<STRIDE>(g, s + a * ax.ms, t + a * ax.mt, "
        "ax.minor_len);")
_FLOOR_MOD = "{ return ((a % w) + w) % w; }"
_LOAD = "return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};"
_QUAD = "float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);"
# part -> [(file, old text, new text)]
PARTS = {
    "level": [("mipmap.cu", _TRI, _TRI_AT),
              ("mipmap.cu", _AXES, _AXES + "    rt_mip::Tri tl = "
               "rt_mip::tri_levels(g.n_levels, ax.minor_len);\n"),
              ("mipmap.cu", _TAP, "Tex v = trilinear_at<STRIDE>(g, tl, s + a "
               "* ax.ms, t + a * ax.mt);")],
    "wrap": [("atlas.cuh", _FLOOR_MOD, "{ return min(max(a, 0), w - 1); }")],
    "loads": [("atlas.cuh", _LOAD, "float v = (float)(p - texels) * 1e-9f; "
               "return {v, v, v};"),
              ("atlas.cuh", _QUAD, "float4 a = make_float4((float)row * "
               "1e-9f, 0.5f, 0.25f, 0.125f), b = a, c = a;")],
    "constant": [("atlas.cuh", _LOAD, "return {0.5f, 0.25f, 0.125f};"),
                 ("atlas.cuh", _QUAD, "float4 a = make_float4(0.5f, 0.25f, "
                  "0.125f, 0.5f), b = a, c = a;")],
}


def replace_once(texts, edits, part):
    """``texts`` ({file: text}) with ``edits`` ([(file, old, new)])
    applied; raises unless each replaced text occurs once (a design the
    part was not written for)."""
    out = dict(texts)
    for name, old, new in edits:
        if out[name].count(old) != 1:
            raise ValueError(f"{part}: the text to replace is not in {name} "
                             "once")
        out[name] = out[name].replace(old, new)
    return out


def part_files(texts, part):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements;
    raises unless each replaced text occurs once."""
    return replace_once(texts, PARTS[part], part)


def write_part_dirs(src, directory, files, parts, main):
    """Write each part's ``files`` under ``directory``/<part> from those in
    ``src``, the part's texts replaced -> {part: path of its ``main``}."""
    texts = {}
    for name in files:
        with open(os.path.join(src, name)) as f:
            texts[name] = f.read()
    paths = {}
    for part, edits in parts.items():
        d = os.path.join(directory, part)
        os.makedirs(d, exist_ok=True)
        for name, text in replace_once(texts, edits, part).items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        paths[part] = os.path.join(d, main)
    return paths


def write_parts(src, directory):
    """Write each part's four files under ``directory`` from those in
    ``src`` -> {part: path of its mipmap.cu}."""
    return write_part_dirs(src, directory, FILES, PARTS, "mipmap.cu")


if __name__ == "__main__":
    for path in write_parts(sys.argv[1], sys.argv[2]).values():
        print(path)
