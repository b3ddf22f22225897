"""Diagnostic builds of K4d, the checkpointed render's deterministic splat
(csrc/film.cu ``film_add_det_kernel``), in the design that ran one thread
a film pixel and read each lane of its tap window from global memory: each
build changes one part of the work, so that
``tools/bench_step_kernels.py --kernels K4d --time-only`` can time what
the parts cost on the recorded full-width Mitchell splat. The first and
third keep the splat's bits; the second computes a wrong splat on purpose:

- ``exact``: the window of offsets walked without the one extra offset on
  each side that ``Film.det_window`` adds against rounding (PBRT's radius
  2: 5 x 5 lanes a pixel, not 7 x 7);
- ``once``: a tap's luminance clamp and filter weight dropped (a constant
  weight): the cost of computing them again for each pixel a sample
  reaches, which a design computing them once a sample saves;
- ``staged``: each block's window of lanes (positions, valid flags and
  radiance) copied into shared memory with coalesced loads first, the
  pixel loop reading them there, the rest as it was.

With ``--tiles``, the parts of the tiled design (``TILE_PARTS``, applied
to SRC rustracer_tpu_torch/csrc as it is; the first two keep the bits):

- ``window7``: every pixel walks the whole 7 x 7 window (no block-wide
  range of the lanes' footprints);
- ``tile8``: tiles of 32 x 8 pixels (256 threads) in place of 32 x 16;
- ``noweights``: a staged lane's axis weights constants (no filter
  evaluation in the staging);
- ``cap4``: the tile kernel's registers capped for 4 blocks of 512
  threads an SM (__launch_bounds__'s second argument).

    python -m rustracer_tpu_torch.tools.k4d_parts SRC DIR [--tiles]

SRC holds that design's film.cu, filter.cuh and common.cuh (for instance
``git show <commit>:rustracer_tpu_torch/csrc/<file>`` of a commit before
the redesign); writes DIR/<part>/ with the three files, the part's text
replaced, and prints each part's film.cu.
"""
from __future__ import annotations

import sys

from .k17_parts import replace_once, write_part_dirs

FILES = ("film.cu", "filter.cuh", "common.cuh")
_OY = "    for (int oy = ohy; oy >= oly; --oy) {\n"
_OX = "        for (int ox = ohx; ox >= olx; --ox) {\n"
_WEIGHT = ("            const float fw = rt::filter_weight<Kind>(f, ((float)X "
           "+ 0.5f) - p.x,\n"
           "                                                     ((float)Y "
           "+ 0.5f) - p.y);\n")
_CLAMP = ("            float r = rad[3 * lane], g = rad[3 * lane + 1], "
          "b = rad[3 * lane + 2];\n"
          "            if (isfinite(max_lum)) {\n")
_HEAD = ("    const long long t = (long long)blockIdx.x * kThreads + "
         "threadIdx.x;\n"
         "    if (t >= (long long)rows * w) return;\n"
         "    const int iy = row0 + (int)(t / w), ix = (int)(t % w);\n"
         "    const int X = ix + x0, Y = iy + y0;\n")
# the staged window: the block's pixels span [xa, xb] x [ya, yb] (every
# column where they wrap a row), its lanes those of the pixels the window
# of offsets reaches them from; at most kStage lanes, else read as before
_STAGED_HEAD = """    constexpr int kStage = 1848;
    __shared__ float2 s_p[kStage];
    __shared__ float s_rgb[3 * kStage];
    __shared__ bool s_v[kStage];
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long t0 = (long long)blockIdx.x * kThreads;
    const long long t1 = min(t0 + kThreads, (long long)rows * w) - 1;
    const int ya = row0 + (int)(t0 / w), yb = row0 + (int)(t1 / w);
    const int xa = ya == yb ? (int)(t0 % w) : 0, xb = ya == yb ? (int)(t1 % w) : w - 1;
    const int SX = xa + x0 - ohx, SY = ya + y0 - ohy;
    const int SW = xb - xa + ohx - olx + 1, SH = yb - ya + ohy - oly + 1;
    const bool staged = SW * SH <= kStage;
    if (staged) {
        for (int e = threadIdx.x; e < SW * SH; e += kThreads) {
            const int gy = SY + e / SW - sy0, gx = SX + e % SW - sx0;
            const long long l = (long long)gy * sw + gx - first;
            const bool in = gx >= 0 && gx < sw && gy >= 0 && gy < sh && l >= 0 && l < n &&
                            (valid == nullptr || valid[l]);
            s_v[e] = in;
            if (in) {
                s_p[e] = p_film[l];
                s_rgb[3 * e] = rad[3 * l];
                s_rgb[3 * e + 1] = rad[3 * l + 1];
                s_rgb[3 * e + 2] = rad[3 * l + 2];
            }
        }
    }
    __syncthreads();
    if (t >= (long long)rows * w) return;
    const int iy = row0 + (int)(t / w), ix = (int)(t % w);
    const int X = ix + x0, Y = iy + y0;
"""
_LANE = ("            if (lane < 0 || lane >= n || (valid != nullptr && "
         "!valid[lane])) continue;\n"
         "            const float2 p = p_film[lane];\n")
_STAGED_LANE = """            int e = 0;
            if (staged) {
                e = (Y - oy - SY) * SW + (X - ox - SX);
                if (!s_v[e]) continue;
            } else if (lane < 0 || lane >= n || (valid != nullptr && !valid[lane])) {
                continue;
            }
            const float2 p = staged ? s_p[e] : p_film[lane];
"""
_STAGED_RGB = ("            float r = staged ? s_rgb[3 * e] : rad[3 * lane], "
               "g = staged ? s_rgb[3 * e + 1] : rad[3 * lane + 1],\n"
               "                  b = staged ? s_rgb[3 * e + 2] : "
               "rad[3 * lane + 2];\n"
               "            if (isfinite(max_lum)) {\n")
# part -> [(file, old text, new text)]
PARTS = {
    "exact": [("film.cu", _OY,
               "    for (int oy = ohy - 1; oy >= oly + 1; --oy) {\n"),
              ("film.cu", _OX,
               "        for (int ox = ohx - 1; ox >= olx + 1; --ox) {\n")],
    "once": [("film.cu", _WEIGHT, "            const float fw = 0.0625f;\n"),
             ("film.cu", _CLAMP, _CLAMP.replace("isfinite(max_lum)",
                                                "false"))],
    "staged": [("film.cu", _HEAD, _STAGED_HEAD),
               ("film.cu", _LANE, _STAGED_LANE),
               ("film.cu", _CLAMP, _STAGED_RGB)],
}


_TAPS = ("        const rt::AxisTaps wx = rt::axis_taps<Kind, 0>(f, lo_x, "
         "p.x, nx);\n"
         "        const rt::AxisTaps wy = rt::axis_taps<Kind, 1>(f, lo_y, "
         "p.y, ny);\n")
TILE_PARTS = {
    "window7": [("film.cu",
                 "    const int dx0 = max(s_range[0] - nx + 1, 0), "
                 "dx1 = min(s_range[1], ww - 1);\n"
                 "    const int dy0 = max(s_range[2] - ny + 1, 0), "
                 "dy1 = min(s_range[3], wh - 1);\n",
                 "    const int dx0 = 0, dx1 = ww - 1;\n"
                 "    const int dy0 = 0, dy1 = wh - 1;\n")],
    "tile8": [("film.cu", "constexpr int kDetW = 32, kDetH = 16, ",
               "constexpr int kDetW = 32, kDetH = 8, ")],
    "cap4": [("film.cu", "__global__ void __launch_bounds__(kDetThreads)\n",
              "__global__ void __launch_bounds__(kDetThreads, 4)\n")],
    "noweights": [("film.cu", _TAPS,
                   "        const rt::AxisTaps wx{0.25f, 0.5f, 0.5f, "
                   "0.25f + 0.0f * p.x}, wy{0.25f, 0.5f, 0.5f, 0.25f + "
                   "0.0f * p.y};\n")],
}


def part_files(texts, part, parts=PARTS):
    """``texts`` ({file: text} of FILES) with ``part``'s replacements (of
    ``parts``); raises unless each replaced text occurs once."""
    return replace_once(texts, parts[part], part)


def write_parts(src, directory, parts=PARTS):
    """Write each part's three files under ``directory`` from those in
    ``src`` -> {part: path of its film.cu}."""
    return write_part_dirs(src, directory, FILES, parts, "film.cu")


if __name__ == "__main__":
    chosen = TILE_PARTS if "--tiles" in sys.argv[3:] else PARTS
    for path in write_parts(sys.argv[1], sys.argv[2], chosen).values():
        print(path)
