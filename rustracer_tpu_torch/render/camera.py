"""Perspective camera with thin-lens depth of field and ray differentials
(port of rustracer_tpu/render/camera.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math import normalize
from ..core.ray import Ray
from ..core.sampling import concentric_sample_disk
from ..core.transform import Transform, xform_point, xform_vector


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    camera_to_world: np.ndarray     # (4, 4) float32
    raster_to_camera: np.ndarray    # (4, 4) float32
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    shutter_open: float = 0.0
    shutter_close: float = 1.0

    @staticmethod
    def create(cam2world: Transform, fov=90.0, lens_radius=0.0,
               focal_distance=1e6, resolution=(640, 480), screen_window=None,
               shutter_open=0.0, shutter_close=1.0):
        """Raster -> screen -> camera chain for a film of ``resolution``;
        ``screen_window`` (x0, x1, y0, y1) defaults to the aspect's."""
        xr, yr = resolution
        aspect = xr / yr
        if screen_window is not None:
            x0, x1, y0, y1 = screen_window
        elif aspect > 1.0:
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
                                 raster_to_camera=raster_to_camera.m,
                                 lens_radius=float(lens_radius),
                                 focal_distance=float(focal_distance),
                                 shutter_open=float(shutter_open),
                                 shutter_close=float(shutter_close))

    def _mats(self, device):
        return (torch.as_tensor(self.raster_to_camera, device=device),
                torch.as_tensor(self.camera_to_world, device=device))

    def _ray_camera_space(self, r2c, p_film, p_lens_u):
        """Camera-space (o, d) of film points; the thin lens moves the
        origin onto the lens and aims at the plane of focus."""
        p_raster = torch.cat([p_film, torch.zeros_like(p_film[:, :1])], -1)
        d = normalize(xform_point(r2c, p_raster))
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0:
            p_lens = self.lens_radius * concentric_sample_disk(p_lens_u)
            # a float32 divide, as the reference's (a Python number over a
            # tensor would multiply by the tensor's reciprocal)
            ft = d.new_tensor(self.focal_distance) / d[:, 2]
            p_focus = d * ft[:, None]
            o = torch.cat([p_lens, torch.zeros_like(p_lens[:, :1])], -1)
            d = normalize(p_focus - o)
        return o, d

    def generate_ray_differential(self, p_film, p_lens_u=None) -> Ray:
        """p_film (B, 2) raster positions, p_lens_u (B, 2) lens samples in
        [0, 1)^2 (read only by a thin lens) -> rays with x/y
        differentials."""
        if self.lens_radius > 0.0 and p_lens_u is None:
            raise ValueError("a thin-lens camera needs the lens sample")
        r2c, c2w = self._mats(p_film.device)
        o, d = self._ray_camera_space(r2c, p_film, p_lens_u)
        ox, dx = self._ray_camera_space(
            r2c, p_film + p_film.new_tensor([1.0, 0.0]), p_lens_u)
        oy, dy = self._ray_camera_space(
            r2c, p_film + p_film.new_tensor([0.0, 1.0]), p_lens_u)
        return Ray(o=xform_point(c2w, o), d=normalize(xform_vector(c2w, d)),
                   t_max=torch.full_like(o[:, 0], float("inf")),
                   rx_origin=xform_point(c2w, ox),
                   rx_direction=normalize(xform_vector(c2w, dx)),
                   ry_origin=xform_point(c2w, oy),
                   ry_direction=normalize(xform_vector(c2w, dy)))
