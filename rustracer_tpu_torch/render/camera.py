"""Perspective pinhole camera with ray differentials (port of
rustracer_tpu/render/camera.py without the thin lens)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import normalize
from ..core.ray import Ray
from ..core.transform import Transform, xform_point, xform_vector


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    camera_to_world: np.ndarray     # (4, 4) float32
    raster_to_camera: np.ndarray    # (4, 4) float32

    @staticmethod
    def create(cam2world: Transform, fov=90.0, resolution=(640, 480)):
        """Raster -> screen -> camera chain for a film of ``resolution``."""
        xr, yr = resolution
        aspect = xr / yr
        if aspect > 1.0:
            x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
        else:
            x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
        cam_to_screen = Transform.perspective(fov, 1e-2, 1000.0)
        screen_to_raster = (Transform.scale(xr, yr, 1.0)
                            * Transform.scale(1.0 / (x1 - x0),
                                              1.0 / (y0 - y1), 1.0)
                            * Transform.translate(-x0, -y1, 0.0))
        raster_to_camera = cam_to_screen.inverse() * screen_to_raster.inverse()
        return PerspectiveCamera(camera_to_world=cam2world.m,
                                 raster_to_camera=raster_to_camera.m)

    def _mats(self, device):
        return (torch.as_tensor(self.raster_to_camera, device=device),
                torch.as_tensor(self.camera_to_world, device=device))

    @staticmethod
    def _direction(r2c, p_film):
        p_raster = torch.cat([p_film, torch.zeros_like(p_film[:, :1])], -1)
        return normalize(xform_point(r2c, p_raster))

    def generate_ray_differential(self, p_film, p_lens_u=None) -> Ray:
        """p_film (B, 2) raster positions -> rays with x/y differentials."""
        r2c, c2w = self._mats(p_film.device)
        o = torch.zeros((p_film.shape[0], 3), dtype=torch.float32,
                        device=p_film.device)
        d = self._direction(r2c, p_film)
        dx = self._direction(r2c, p_film + p_film.new_tensor([1.0, 0.0]))
        dy = self._direction(r2c, p_film + p_film.new_tensor([0.0, 1.0]))
        o_w = xform_point(c2w, o)
        return Ray(o=o_w, d=normalize(xform_vector(c2w, d)),
                   t_max=torch.full_like(o[:, 0], float("inf")),
                   rx_origin=o_w, rx_direction=normalize(xform_vector(c2w, dx)),
                   ry_origin=o_w, ry_direction=normalize(xform_vector(c2w, dy)))
