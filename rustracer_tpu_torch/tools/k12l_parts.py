"""Diagnostic builds of K12's lights kernel (csrc/lightdistrib.cu
``grid_contrib_lights_kernel`` with csrc/lights.cuh), in the design that
ran every light type in one kernel, the cone's trig per (voxel, probe)
and each distant or sky column summed by every thread: each build changes
one part of the work, so that ``tools/bench_step_kernels.py --kernels
K12L --time-only`` can time what the parts cost on the bathroom's grid
and on each branch alone:

- ``cone_staged``: cosf and sinf of the cone's phi computed once a probe
  in the block's staging and read there (the same sums);
- ``nosum``: a distant or sky column written without the per-thread sum
  of the probes (its last probe's value: wrong on purpose);
- ``tri_only``: the kernel compiled with the triangle branch alone, for
  its registers (every row summed as a triangle: wrong on purpose but on
  triangle tables).

With ``--tune``, variants of the present design (``TUNE_PARTS``, applied
to SRC rustracer_tpu_torch/csrc as it is; the same sums):

- ``unroll1``, ``unroll2``: the quadric and cone branches' probe loop
  unrolled by 1 (not at all) or 2 (``#pragma unroll``), the compiler's
  choice otherwise;
- ``sets3``, ``sets5``: the branches other than the triangle lights'
  launched as two sets (the quadrics; the point, distant and infinite
  lights) or one launch a branch (quadric, full sphere, point, uniform),
  where the present design launches them all as one; every launch covers
  every row, so a table without a set's branches still pays its launch;
- ``one_queue``: every block of the lights kernel's wave takes its items
  from one queue, in the order the blocks ask, where the present design
  keeps a queue an SM (each block asking its own SM's first): the items of
  one branch then go to the blocks that start first, several on one SM;
- ``minblocks5``: the lights kernel's registers capped for 5 blocks an SM
  (``__launch_bounds__(kThreads, 5)``).

An infinite light's map and tables staged in each uniform block's shared
memory ran slower and left the tool with that design; so did a grid of an
item a block, a wave of blocks that walk the items in a fixed order, and
such a wave of at most 2, 3 or 4 blocks an SM.

    python -m rustracer_tpu_torch.tools.k12l_parts SRC DIR [--tune]

SRC holds that design's lightdistrib.cu, lights.cuh, quadrics.cuh and
common.cuh (for instance ``git show
<commit>:rustracer_tpu_torch/csrc/<file>`` of a commit before the
redesign); writes DIR/<part>/ with the four files, the part's text
replaced, and prints each part's lightdistrib.cu.
"""
from __future__ import annotations

import sys

from .k17_parts import replace_once, write_part_dirs

FILES = ("lightdistrib.cu", "lights.cuh", "quadrics.cuh", "common.cuh")
_SHARED = "    __shared__ float s_c[kMaxProbes];\n"
_STAGE = "            rt::quadric_sample(Q, u0, u1, &p, &n);\n"
_CALL = ("            const bool in_cone = cone && rt::cone_sample(Q, p, "
         "lp.w, ln.w, &pa, &na, &cpdf);\n")
_SIG = ("__device__ __forceinline__ bool cone_sample(const QLight& Q, V3 ref, "
        "float u0, float u1, V3* p,\n"
        "                                            V3* n, float* pdf) {\n")
_PHI = "    const float phi = u1 * 2.0f * kPi;\n"
_NS = ("    const V3 ns = ((sina * cosf(phi)) * -wcx + (sina * sinf(phi)) * "
       "-wcy) + cosa * -wc;\n")
_SUM = "        for (int s = 0; s < n_probes; ++s) sum = sum + s_c[s];\n"
_TYPE = ("    const int type = L.type[j];\n"
         "    const bool tri = type == kArea && L.q_type[j] < 0;\n")
# part -> [(file, old text, new text)]
PARTS = {
    "cone_staged": [
        ("lightdistrib.cu", _SHARED,
         _SHARED + "    __shared__ float2 s_cs[kMaxProbes];\n"),
        ("lightdistrib.cu", _STAGE,
         _STAGE + "            const float phi = u1 * 2.0f * rt::kPi;\n"
         "            s_cs[s] = make_float2(cosf(phi), sinf(phi));\n"),
        ("lightdistrib.cu", _CALL,
         "            const bool in_cone = cone && rt::cone_sample(Q, p, "
         "lp.w, s_cs[s].x, s_cs[s].y, &pa, &na, &cpdf);\n"),
        ("lights.cuh", _SIG,
         "__device__ __forceinline__ bool cone_sample(const QLight& Q, V3 "
         "ref, float u0, float cphi,\n"
         "                                            float sphi, V3* p, V3* "
         "n, float* pdf) {\n"),
        ("lights.cuh", _PHI, ""),
        ("lights.cuh", _NS,
         "    const V3 ns = ((sina * cphi) * -wcx + (sina * sphi) * -wcy) + "
         "cosa * -wc;\n")],
    "nosum": [("lightdistrib.cu", _SUM,
               "        sum = s_c[n_probes - 1];\n")],
    "tri_only": [("lightdistrib.cu", _TYPE,
                  "    const int type = kArea;\n"
                  "    const bool tri = true;\n")],
}
_QLOOP = ("            for (int s = 0; s < n_probes; ++s) {\n"
          "                const float4 h = s_h[s], lp = s_p[s], ln = s_n[s];\n")
TUNE_PARTS = {f"unroll{k}": [("lightdistrib.cu", _QLOOP,
                              f"#pragma unroll {k}\n" + _QLOOP)]
              for k in (1, 2)}
_SETS = ("using LightSets = Sets<bit(kQuad) | bit(kCone) | bit(kPointRow) | "
         "bit(kUniform)>;\n")
TUNE_PARTS["sets3"] = [("lightdistrib.cu", _SETS,
                        "using LightSets = Sets<bit(kQuad) | bit(kCone), "
                        "bit(kPointRow) | bit(kUniform)>;\n")]
TUNE_PARTS["sets5"] = [("lightdistrib.cu", _SETS,
                        "using LightSets = Sets<bit(kQuad), bit(kCone), "
                        "bit(kPointRow), bit(kUniform)>;\n")]
TUNE_PARTS["one_queue"] = [
    ("lightdistrib.cu", "    *queues = std::min(sms, kMaxQueues);\n",
     "    *queues = 1;\n")]
TUNE_PARTS["minblocks5"] = [
    ("lightdistrib.cu",
     "__global__ void __launch_bounds__(kThreads)\n"
     "    grid_contrib_lights_kernel(",
     "__global__ void __launch_bounds__(kThreads, 5)\n"
     "    grid_contrib_lights_kernel(")]


def part_files(texts, part, parts=PARTS):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements (of
    ``parts``); raises unless each replaced text occurs once."""
    return replace_once(texts, parts[part], part)


def write_parts(src, directory, parts=PARTS):
    """Write each part's four files under ``directory`` from those in
    ``src`` -> {part: path of its lightdistrib.cu}."""
    return write_part_dirs(src, directory, FILES, parts, "lightdistrib.cu")


if __name__ == "__main__":
    chosen = TUNE_PARTS if "--tune" in sys.argv[3:] else PARTS
    for path in write_parts(sys.argv[1], sys.argv[2], chosen).values():
        print(path)
