"""Diagnostic builds of K20, the texel gradient of the per-texture lookups
(csrc/mipmap_bwd.cu), in the design that added each of a lane's corners
apart (one thread a lane, the level found again for every tap, each corner
through texel_grad.cuh add_texel): each build changes one part of the
work, so that ``tools/bench_step_kernels.py --kernels K20 --time-only``
can time what the parts cost on a recorded textures-train backward. All
but ``level`` compute wrong gradients on purpose:

- ``level``: the 8-tap lookup's two levels found once a lane, not once a
  tap (the same gradient);
- ``atomic``: add_texel's warp match and shuffle tree dropped, every
  corner one global atomic a channel into its own texel;
- ``noadds``: no add at all (the weights and texel indices still
  computed, kept alive by a test that never passes);
- ``keys``: each corner's texel a constant of the lane (its thread index,
  within the first 32,768 texels): no address arithmetic, and no two
  lanes of a warp on one texel.

A part of the packed design (csrc/mipmap_bwd.cu as it is: the lanes that
add packed a tile, G threads a lookup), ``PACKED_PARTS``, computes the
same gradient, so the tool can hold it to the plain version (``--other``):

- ``inplace``: no lane left out of the packing (texel_grad.cuh
  pack_tile), so every lane runs where it is, in lane order, as in the
  design with one thread a lane: what the packing costs or saves on
  each call.

    python -m rustracer_tpu_torch.tools.k20_parts SRC DIR [--packed]

SRC holds that design's mipmap_bwd.cu, mipmap.cuh, atlas.cuh,
texel_grad.cuh and common.cuh (for instance ``git show
<commit>:rustracer_tpu_torch/csrc/<file>`` of a commit before the
redesign, or with ``--packed`` rustracer_tpu_torch/csrc); writes
DIR/<part>/ with the five files, the part's text replaced, and prints
each part's mipmap_bwd.cu.
"""
from __future__ import annotations

import sys

from .k17_parts import replace_once, write_part_dirs

FILES = ("mipmap_bwd.cu", "mipmap.cuh", "atlas.cuh", "texel_grad.cuh",
         "common.cuh")
_NORM = "    gr = gr / g.wsum;\n"
_TAP = ("        trilinear_bwd(g, emit, s + a * ax.ms, t + a * ax.mt, "
        "ax.minor_len, gr * g.w[k],\n"
        "                      gg * g.w[k], gb * g.w[k]);\n")
_TAP_AT = ("        float tr = gr * g.w[k], tg = gg * g.w[k], tb = gb * "
           "g.w[k];\n"
           "        bilerp_bwd(g, emit, l0, s + a * ax.ms, t + a * ax.mt, "
           "tr * w0, tg * w0, tb * w0);\n"
           "        bilerp_bwd(g, emit, l1, s + a * ax.ms, t + a * ax.mt, "
           "tr * w1, tg * w1, tb * w1);\n")
_MATCH = ("    const int lane = threadIdx.x & 31;\n"
          "    const unsigned peers = __match_any_sync(0xffffffffu, key);\n")
_KEY = ("int key = emit ? texel_index(lv, g.wrap, s0 + (c & 1), t0 + (c >> 1))"
        " : -1;")
# part -> [(file, old text, new text)]
PARTS = {
    "level": [("mipmap_bwd.cu", _NORM, "    rt_mip::Tri tl = "
               "rt_mip::tri_levels(g.n_levels, ax.minor_len);\n"
               "    Level l0 = rt_mip::level(g.meta, tl.l0), l1 = "
               "rt_mip::level(g.meta, tl.l1);\n"
               "    float w0 = 1.0f - tl.dl, w1 = tl.dl;\n" + _NORM),
              ("mipmap_bwd.cu", _TAP, _TAP_AT)],
    "atomic": [("texel_grad.cuh", _MATCH,
                "    if (key >= 0) {\n"
                "        float* q = g_tex + 3 * (long long)key;\n"
                "        if (r != 0.0f) atomicAdd(q, r);\n"
                "        if (g != 0.0f) atomicAdd(q + 1, g);\n"
                "        if (b != 0.0f) atomicAdd(q + 2, b);\n"
                "    }\n"
                "    return;\n" + _MATCH)],
    "noadds": [("texel_grad.cuh", _MATCH,
                "    if (key >= 0 && r + g + b == 1.2345e-30f) g_tex[0] = "
                "0.0f;\n"
                "    return;\n" + _MATCH)],
    "keys": [("mipmap_bwd.cu", _KEY,
              "int key = emit ? (int)((blockIdx.x * blockDim.x + threadIdx.x)"
              " * 4 + c) & 32767 : -1;")],
}


# parts of the packed design: part -> [(file, old text, new text)]
PACKED_PARTS = {
    "inplace": [("texel_grad.cuh",
                 "on[j] = t < in_tile && active(base + t);",
                 "on[j] = t < in_tile;")],
}


def part_files(texts, part, parts=PARTS):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements (of
    ``parts``); raises unless each replaced text occurs once."""
    return replace_once(texts, parts[part], part)


def write_parts(src, directory, parts=PARTS):
    """Write each of ``parts``' five files under ``directory`` from those
    in ``src`` -> {part: path of its mipmap_bwd.cu}."""
    return write_part_dirs(src, directory, FILES, parts, "mipmap_bwd.cu")


if __name__ == "__main__":
    chosen = PACKED_PARTS if "--packed" in sys.argv[3:] else PARTS
    for path in write_parts(sys.argv[1], sys.argv[2], chosen).values():
        print(path)
