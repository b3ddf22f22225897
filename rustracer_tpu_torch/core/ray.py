"""Ray batches (port of rustracer_tpu/core/ray.py): (..., 3) origins and
directions, (...) t_max, and optional x/y differentials."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Ray:
    o: torch.Tensor
    d: torch.Tensor
    t_max: torch.Tensor
    rx_origin: Optional[torch.Tensor] = None
    rx_direction: Optional[torch.Tensor] = None
    ry_origin: Optional[torch.Tensor] = None
    ry_direction: Optional[torch.Tensor] = None

    @property
    def has_differentials(self):
        return self.rx_origin is not None

    def scaled_differentials(self, s: float) -> "Ray":
        """Scale the differentials for spp > 1."""
        if not self.has_differentials:
            return self
        return dataclasses.replace(
            self,
            rx_origin=self.o + (self.rx_origin - self.o) * s,
            ry_origin=self.o + (self.ry_origin - self.o) * s,
            rx_direction=self.d + (self.rx_direction - self.d) * s,
            ry_direction=self.d + (self.ry_direction - self.d) * s)
