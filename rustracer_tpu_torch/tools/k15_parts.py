"""Diagnostic builds of K15, the infinite light's sample (csrc/lights.cu
``infinite_sample_kernel`` with csrc/lights.cuh), in the design that ran
one thread a lane over the tables in global memory: each build changes
one part of the work, so that ``tools/bench_step_kernels.py --kernels K15
--time-only`` can time what the parts cost on the recorded bathroom
step's calls. All but ``shared`` compute wrong samples on purpose:

- ``sky``: every lane sampled as infinite light 0 (no lane leaves early);
- ``zeros``: no lane sampled (each writes its zeros after reading its
  light row): the floor of the lanes' loads and stores;
- ``fixed``: both bisections replaced by a fixed interval (the middle
  row and column: no cdf read in the search);
- ``trig``: sinf and cosf of theta and phi replaced by constants (their
  arguments still computed);
- ``shared``: light 0's conditional and marginal tables copied into each
  block's shared memory first (at most 12,000 floats), the bisections
  reading them there (the same samples).

With ``--tune``, variants of the present design (``TUNE_PARTS``, applied
to SRC rustracer_tpu_torch/csrc as it is; each the same samples):

- ``late``: u and p loaded where the design before it loaded them (u in
  the search, p after it);
- ``cap7``, ``cap8``: the kernel's registers capped for 7 or 8 blocks of
  256 threads an SM (__launch_bounds__'s second argument), so that the
  step's 1,024 blocks fit one wave at 8;
- ``cap8late``: both;
- ``offsets``: the light's tables addressed by their 32-bit offsets from
  the descriptor where they are read (lights.cuh sample_2d's steps written
  out in the kernel), not by seven 64-bit pointers held through the
  chain; ``offsets8`` with the cap for 8 blocks, ``offsets8late`` with
  the cap and ``late``.

    python -m rustracer_tpu_torch.tools.k15_parts SRC DIR [--tune]

SRC holds that design's lights.cu, lights.cuh, quadrics.cuh and
common.cuh (for instance ``git show
<commit>:rustracer_tpu_torch/csrc/<file>`` of a commit before the
redesign); writes DIR/<part>/ with the four files, the part's text
replaced, and prints each part's lights.cu.
"""
from __future__ import annotations

import sys

from .k17_parts import replace_once, write_part_dirs

FILES = ("lights.cu", "lights.cuh", "quadrics.cuh", "common.cuh")
_K = ("    const int k = row >= 0 && row < n_lights ? row_inf[row] : -1;\n")
_HEAD = ("    const long long i = (long long)blockIdx.x * kThreads + "
         "threadIdx.x;\n"
         "    if (i >= n) return;\n"
         "    const int row = lid[i];\n")
_SHARED_HEAD = """    constexpr int kStage = 12000;
    __shared__ float s_tab[kStage];
    const int lo = desc[3], cnt = desc[8] + 1 - desc[3];
    const bool staged = cnt <= kStage;
    if (staged) {
        for (int j = threadIdx.x; j < cnt; j += kThreads) s_tab[j] = flat[lo + j];
    }
    __syncthreads();
""" + _HEAD
_LIGHT = "    }\n    const rt::InfLight L = rt::inf_light(flat, desc, k);\n"
_SHARED_LIGHT = """    }
    rt::InfLight L = rt::inf_light(flat, desc, k);
    if (staged && k == 0) {
        const float* sb = s_tab - lo;
        L.cfunc = sb + desc[3];
        L.ccdf = sb + desc[4];
        L.cint = sb + desc[5];
        L.mfunc = sb + desc[6];
        L.mcdf = sb + desc[7];
        L.mint = sb + desc[8];
    }
"""
_SEARCH = "    while (lo < hi) {\n"
_FOUND = "    return min(max(lo - 1, 0), n - 2);\n"
_THETA = "    const float s = sinf(theta), c = cosf(theta);\n"
_PHI = "    return xform_vector(l2w, V3{s * cosf(phi), s * sinf(phi), c});\n"
# part -> [(file, old text, new text)]
PARTS = {
    "sky": [("lights.cu", _K, "    const int k = 0;\n")],
    "zeros": [("lights.cu", _K, "    const int k = row == -12345 ? 0 : -1;\n")],
    "fixed": [("lights.cuh", _SEARCH, "    while (false && lo < hi) {\n"),
              ("lights.cuh", _FOUND, "    return (n - 2) / 2;\n")],
    "trig": [("lights.cuh", _THETA, "    const float s = 0.5f + 0.0f * "
              "theta, c = 0.75f + 0.0f * theta;\n"),
             ("lights.cuh", _PHI, "    return xform_vector(l2w, V3{s * "
              "(0.6f + 0.0f * phi), s * 0.8f, c});\n")],
    "shared": [("lights.cu", _HEAD, _SHARED_HEAD),
               ("lights.cu", _LIGHT, _SHARED_LIGHT)],
}


_BOUNDS = ("__global__ void __launch_bounds__(kThreads)\n"
           "    infinite_sample_kernel(")
_EARLY = ("    const float u0 = u[2 * i], u1 = u[2 * i + 1];\n"
          "    const rt::V3 pi = rt::load3(p + 3 * i);\n")
_USE_U = "    rt::sample_2d(L, u0, u1, &uv0, &uv1, &map_pdf);\n"
_USE_P = ("    rt::store3(pt_out + 3 * i, pi + wi * (2.0f * "
          "world_radius));\n")
_LATE = [("lights.cu", _EARLY, ""),
         ("lights.cu", _USE_U, "    rt::sample_2d(L, u[2 * i], u[2 * i + 1], "
          "&uv0, &uv1, &map_pdf);\n"),
         ("lights.cu", _USE_P, "    rt::store3(pt_out + 3 * i, rt::load3(p + "
          "3 * i) + wi * (2.0f * world_radius));\n")]


def _cap(blocks):
    return [("lights.cu", _BOUNDS, _BOUNDS.replace(
        "(kThreads)", f"(kThreads, {blocks})"))]


_LIGHT = """    const rt::InfLight L = rt::inf_light(flat, desc, k);
    float uv0, uv1, map_pdf, st;
"""
_OFFSETS_LIGHT = """    const int* d = desc + rt::kDescWords * k;
    const int h = d[0], w = d[1];
    float uv0, uv1, map_pdf, st;
"""
_OFFSETS_SAMPLE = """    {
        float pdf0, pdf1;
        int v, col;
        uv1 = rt::sample_1d(flat + d[6], flat + d[7], flat[d[8]], h, u1, &pdf1, &v);
        uv0 = rt::sample_1d(flat + d[3] + (size_t)v * w, flat + d[4] + (size_t)v * (w + 1),
                            flat[d[5] + v], w, u0, &pdf0, &col);
        map_pdf = pdf0 * pdf1;
    }
"""
_BILERP = ("    const rt::V3 le = rt::bilerp_repeat(L.map, L.h, L.w, uv0, "
           "uv1);\n")
_OFFSETS = [("lights.cu", _LIGHT, _OFFSETS_LIGHT),
            ("lights.cu", _USE_U, _OFFSETS_SAMPLE),
            ("lights.cu", _BILERP, _BILERP.replace("L.map, L.h, L.w",
                                                   "flat + d[2], h, w"))]
TUNE_PARTS = {"late": _LATE, "cap7": _cap(7), "cap8": _cap(8),
              "cap8late": _cap(8) + _LATE, "offsets": _OFFSETS,
              "offsets8": _OFFSETS + _cap(8),
              "offsets8late": [
                  _OFFSETS[0],
                  ("lights.cu", _USE_U, _OFFSETS_SAMPLE.replace(
                      "h, u1, &pdf1", "h, u[2 * i + 1], &pdf1").replace(
                      "w, u0, &pdf0", "w, u[2 * i], &pdf0")),
                  _OFFSETS[2], _LATE[0], _LATE[2]] + _cap(8)}


def part_files(texts, part, parts=PARTS):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements (of
    ``parts``); raises unless each replaced text occurs once."""
    return replace_once(texts, parts[part], part)


def write_parts(src, directory, parts=PARTS):
    """Write each part's four files under ``directory`` from those in
    ``src`` -> {part: path of its lights.cu}."""
    return write_part_dirs(src, directory, FILES, parts, "lights.cu")


if __name__ == "__main__":
    chosen = TUNE_PARTS if "--tune" in sys.argv[3:] else PARTS
    for path in write_parts(sys.argv[1], sys.argv[2], chosen).values():
        print(path)
