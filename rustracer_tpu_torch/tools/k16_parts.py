"""Diagnostic builds of K16, the escaped rays' sky (csrc/lights.cu
``infinite_escape_kernel`` with csrc/lights.cuh), in the design that ran
both forms in one kernel and read each light's tables inside the lane's
loop: each build changes one part of the work, so that
``tools/bench_step_kernels.py --kernels K16 --time-only`` can time what
the parts cost on the recorded bathroom step's calls and envmap-dof's
camera rays. All but ``nowrap`` and ``camera`` compute wrong radiance on
purpose (``camera`` only on the MIS calls):

- ``zeros``: each lane reads its mask and direction, then writes zeros
  (no light): the floor of the lanes' loads and stores;
- ``nowrap``: the REPEAT wrap of each texel (two integer remainders) by a
  compare and an add or subtract of the side (the same texels for uv in
  [0, 1]);
- ``notrig``: acosf, atan2f and sinf replaced by constants, their
  arguments still computed;
- ``nomap``: no texel load (each texel's value made from its wrapped
  index);
- ``camera``: the MIS code removed (the camera form alone: no sin theta,
  no map pdf, no power heuristic).

With ``--tune``, variants of the present design (``TUNE_PARTS``, applied
to SRC rustracer_tpu_torch/csrc as it is; the same radiance):

- ``cap8``: both forms' registers capped for 8 blocks of 256 threads an
  SM (``__launch_bounds__``'s second argument), so that a step's 2^18
  lanes fit one wave;
- ``early_d``: every lane's direction read with its mask, whatever the
  mask says, not only an escaped lane's after it;
- ``late_pdf``: the MIS form's BSDF pdf and specular flag read where each
  light uses them, not with the mask.

Two and four lanes a thread (their loads in flight together, a step's
lanes in one wave) ran slower and left the tool with that design.

    python -m rustracer_tpu_torch.tools.k16_parts SRC DIR [--tune]

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
_LOOP = "        for (int k = 0; k < n_inf; ++k) {\n"
_WRAP = ("    s %= w;\n"
         "    t %= h;\n"
         "    if (s < 0) s += w;\n"
         "    if (t < 0) t += h;\n")
_THETA = "    const float theta = acosf(fminf(fmaxf(w.z, -1.0f), 1.0f));\n"
_PHI = "    float phi = atan2f(w.y, w.x);\n"
_ST = "    *st = sinf(theta);\n"
_TEXEL = "    return load3(map + 3 * ((size_t)t * w + s));\n"
_MIS = "            if (!mis) {\n"
# part -> [(file, old text, new text)]
PARTS = {
    "zeros": [("lights.cu", _LOOP, "        acc = 0.0f * d;\n"
               "        for (int k = 0; k < 0 * n_inf; ++k) {\n")],
    "nowrap": [("lights.cuh", _WRAP,
                "    s = s < 0 ? s + w : (s >= w ? s - w : s);\n"
                "    t = t < 0 ? t + h : (t >= h ? t - h : t);\n")],
    "notrig": [("lights.cuh", _THETA, "    const float theta = 0.7f + 0.0f * "
                "fminf(fmaxf(w.z, -1.0f), 1.0f);\n"),
               ("lights.cuh", _PHI, "    float phi = 1.3f + 0.0f * (w.y + "
                "w.x);\n"),
               ("lights.cuh", _ST, "    *st = 0.6f + 0.0f * theta;\n")],
    "nomap": [("lights.cuh", _TEXEL, "    const float x = (float)((size_t)t * "
               "w + s);\n    return V3{x, x, x};\n")],
    "camera": [("lights.cu", _MIS, "            if (true) {\n")],
}
_BOUNDS = ("template <bool kMis>\n__global__ void __launch_bounds__(kThreads)\n"
           "    infinite_escape_kernel(")
_D = ("    const rt::V3 d = live ? rt::load3(d_in + 3 * i) : rt::V3{0.0f, 0.0f, "
      "0.0f};\n")
_PDF = ("    const float pdf = kMis && live ? prev_pdf[i] : 0.0f;\n"
        "    const bool spec = kMis && live && prev_spec[i];\n")
_USE = "            escape_one<kMis>(s_l[k], d, flat, pk, pdf, spec, &acc);\n"
TUNE_PARTS = {"cap8": [("lights.cu", _BOUNDS, _BOUNDS.replace(
    "(kThreads)", "(kThreads, 8)"))],
              "early_d": [("lights.cu", _D, _D.replace("= live ?", "= in ?"))],
              "late_pdf": [
                  ("lights.cu", _PDF, ""),
                  ("lights.cu", _USE, _USE.replace(
                      "pdf, spec,", "kMis ? prev_pdf[i] : 0.0f,\n"
                      "                             kMis && prev_spec[i],"))]}


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
