"""Diagnostic builds of K9's staged kernel (csrc/film_bwd.cu) that each
keep one part of its work, so that ``tools/bench_step_kernels.py
--time-only`` can time what the parts cost on the recorded full-width
calls. They compute wrong gradients on purpose:

- ``skeleton``: the samples read, the box staged, the gradient stored, no
  tap summed;
- ``weights``: each tap's weight formed and summed with a constant pixel
  (no shared-memory load);
- ``loads``: each tap's pixel loaded from the box and summed with weight 1.

    python -m rustracer_tpu_torch.tools.k9_parts DIR

writes DIR/<part>/film_bwd.cu beside copies of common.cuh and filter.cuh
and prints their paths.
"""
from __future__ import annotations

import os
import shutil
import sys

from .._build import CSRC

# the staged kernel's tap, and what each part puts in its place
TAP_WEIGHT = "tap_weight<Kind>(wx.at(k), wy.at(j))"
TAP_PIXEL = "make_float4(box[0][e], box[1][e], box[2][e], 0.0f)"
TAP = f"s = add_tap(s, {TAP_WEIGHT},\n                                {TAP_PIXEL});"
PARTS = {
    "skeleton": (TAP, ";"),
    "weights": (TAP_PIXEL, "make_float4(1.0f, 2.0f, 3.0f, 0.0f)"),
    "loads": (TAP_WEIGHT, "1.0f"),
}


def part_source(source, part):
    """``source`` (csrc/film_bwd.cu's text) with the staged kernel's tap
    replaced as ``part`` says; raises unless the text occurs once."""
    old, new = PARTS[part]
    if source.count(old) != 1:
        raise ValueError(f"{part}: the staged kernel's tap is not in the "
                         "source once")
    return source.replace(old, new)


def write_parts(directory):
    """Write each part's film_bwd.cu, with the headers it includes, under
    ``directory`` -> {part: path}."""
    with open(os.path.join(CSRC, "film_bwd.cu")) as f:
        source = f.read()
    paths = {}
    for part in PARTS:
        d = os.path.join(directory, part)
        os.makedirs(d, exist_ok=True)
        for h in ("common.cuh", "filter.cuh"):
            shutil.copy(os.path.join(CSRC, h), d)
        paths[part] = os.path.join(d, "film_bwd.cu")
        with open(paths[part], "w") as f:
            f.write(part_source(source, part))
    return paths


if __name__ == "__main__":
    for path in write_parts(sys.argv[1]).values():
        print(path)
