"""Diagnostic builds of K2's quadric branch (csrc/interaction.cu with
csrc/quadrics.cuh) in the design that ran one thread a lane down one of
three paths, each ending in its own stores, and read the lane's quadric
row from global memory: each build changes one part of the work, so that
``tools/bench_step_kernels.py --kernels K2 --time-only`` can time what the
parts cost on the recorded quadric table, testball and glass bounce-1
calls. Each computes wrong interactions on purpose:

- ``row``: every quadric lane reads quadric 0's row (one address for the
  whole warp) in place of its own;
- ``stores``: the 12 vector streams' stores dropped (kept alive by a test
  that never passes; uv and the three ids still stored);
- ``math``: acosf, atan2f and sinf replaced by constants (their
  arguments still computed).

The fourth part, one path a warp, takes no build: ``--kernels K2`` also
times each case with its lanes sorted by kind on the host (miss,
triangle, then each quadric type), which leaves the kernel as it is.

    python -m rustracer_tpu_torch.tools.k2_parts SRC DIR

SRC holds that design's interaction.cu, quadrics.cuh and common.cuh (for
instance ``git show <commit>:rustracer_tpu_torch/csrc/<file>`` of a
commit before the redesign); writes DIR/<part>/ with the three files, the
part's text replaced, and prints each part's interaction.cu.
"""
from __future__ import annotations

import sys

from .k17_parts import replace_once, write_part_dirs

FILES = ("interaction.cu", "quadrics.cuh", "common.cuh")
_STORE = ("    p[0] = v.x;\n"
          "    p[1] = v.y;\n"
          "    p[2] = v.z;\n")
# part -> [(file, old text, new text)]
PARTS = {
    "row": [("interaction.cu", "o2w[k] = qs.o2w[16 * qid + k];",
             "o2w[k] = qs.o2w[k];"),
            ("interaction.cu", "w2o[k] = qs.w2o[16 * qid + k];",
             "w2o[k] = qs.w2o[k];"),
            ("interaction.cu", "const float* pr = qs.params + 4 * qid;",
             "const float* pr = qs.params;"),
            ("interaction.cu", "int type = qs.type[qid];",
             "int type = qs.type[0];"),
            ("interaction.cu", "if (qs.reverse[qid]) {",
             "if (qs.reverse[0]) {")],
    "stores": [("common.cuh", _STORE,
                "    if (v.x + v.y + v.z == 1.2345e-30f) p[0] = v.x;\n")],
    "math": [("quadrics.cuh", "float phi = atan2f(y, x);",
              "float phi = 0.5f + 0.0f * (x + y);"),
             ("quadrics.cuh", "float theta = acosf(",
              "float theta = 0.75f + 0.0f * ("),
             ("quadrics.cuh", "float theta_min = acosf(",
              "float theta_min = 0.25f + 0.0f * ("),
             ("quadrics.cuh", "float theta_max = acosf(",
              "float theta_max = 1.25f + 0.0f * ("),
             ("quadrics.cuh", "sinf(theta)", "0.5f")],
}


def part_files(texts, part):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements;
    raises unless each replaced text occurs once."""
    return replace_once(texts, PARTS[part], part)


def write_parts(src, directory):
    """Write each part's three files under ``directory`` from those in
    ``src`` -> {part: path of its interaction.cu}."""
    return write_part_dirs(src, directory, FILES, PARTS, "interaction.cu")


if __name__ == "__main__":
    for path in write_parts(sys.argv[1], sys.argv[2]).values():
        print(path)
