"""Reconstruction filter (port of rustracer_tpu/render/filters.py: the box)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Filter:
    kind: str = "box"
    xwidth: float = 0.5
    ywidth: float = 0.5

    def __post_init__(self):
        if self.kind != "box":
            raise NotImplementedError(f"filter {self.kind!r}: only the box "
                                      "filter is ported")

    @property
    def radius(self):
        return (self.xwidth, self.ywidth)

    def evaluate(self, dx, dy):
        """Weight at offset (dx, dy) from the sample: 1 inside the extent."""
        inside = (torch.abs(dx) <= self.xwidth) & (torch.abs(dy) <= self.ywidth)
        return torch.where(inside, 1.0, 0.0).to(torch.float32)
