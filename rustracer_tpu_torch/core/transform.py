"""Transforms (port of rustracer_tpu/core/transform.py, the subset the render
path uses): a host-side numpy matrix + inverse pair for scene build, and
batched point/vector application to (..., 3) tensors written out component
by component in the reference's order."""
from __future__ import annotations

import numpy as np
import torch


class Transform:
    """4x4 matrix and its inverse, float32, host side."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        m = np.eye(4, dtype=np.float32) if m is None else \
            np.asarray(m, np.float32).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        self.m = m
        self.m_inv = np.asarray(m_inv, np.float32).reshape(4, 4)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    @staticmethod
    def translate(x, y, z) -> "Transform":
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [x, y, z]
        mi = np.eye(4, dtype=np.float32)
        mi[:3, 3] = [-x, -y, -z]
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z) -> "Transform":
        m = np.diag(np.array([x, y, z, 1.0], dtype=np.float32))
        mi = np.diag(np.array([1.0 / x, 1.0 / y, 1.0 / z, 1.0],
                              dtype=np.float32))
        return Transform(m, mi)

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """Camera-to-world."""
        eye = np.asarray(eye, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = look - eye
        d = d / np.linalg.norm(d)
        right = np.cross(up / np.linalg.norm(up), d)
        nr = np.linalg.norm(right)
        if nr < 1e-12:
            right = np.cross(np.array([0.0, 1.0, 0.0001]), d)
            nr = np.linalg.norm(right)
        right /= nr
        new_up = np.cross(d, right)
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, 0] = right
        c2w[:3, 1] = new_up
        c2w[:3, 2] = d
        c2w[:3, 3] = eye
        return Transform(c2w.astype(np.float32))

    @staticmethod
    def perspective(fov_deg, near, far) -> "Transform":
        persp = np.array(
            [[1, 0, 0, 0],
             [0, 1, 0, 0],
             [0, 0, far / (far - near), -far * near / (far - near)],
             [0, 0, 1, 0]], dtype=np.float32)
        inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)


def _rows3(m, x, y, z):
    return (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def xform_point(m, p):
    """Apply the (4, 4) tensor m to points (..., 3), with the divide by w."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx, ry, rz = _rows3(m, x, y, z)
    rx = rx + m[0, 3]
    ry = ry + m[1, 3]
    rz = rz + m[2, 3]
    w = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    inv_w = 1.0 / w
    return torch.stack([rx * inv_w, ry * inv_w, rz * inv_w], dim=-1)


def xform_vector(m, v):
    return torch.stack(_rows3(m, v[..., 0], v[..., 1], v[..., 2]), dim=-1)
