"""Transforms (port of rustracer_tpu/core/transform.py): the host-side
numpy matrix + inverse pair, copied as it is (scene build: LookAt, rotate,
concatenation, inverses and handedness come out bit-equal with the
reference's), and batched point/vector application to (..., 3) tensors
written out component by component in the reference's order."""
from __future__ import annotations

import numpy as np
import torch


class Transform:
    """Matrix + inverse pair (reference transform.rs:10). Host side, numpy."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float32)
        m = np.asarray(m, dtype=np.float32).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        else:
            m_inv = np.asarray(m_inv, dtype=np.float32).reshape(4, 4)
        self.m = m
        self.m_inv = m_inv

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def is_identity(self) -> bool:
        return np.array_equal(self.m, np.eye(4, dtype=np.float32))

    def swaps_handedness(self) -> bool:
        """det of upper-left 3x3 < 0 (reference transform.rs:255)."""
        return bool(np.linalg.det(self.m[:3, :3].astype(np.float64)) < 0.0)

    # --- constructors (reference transform.rs translate/rotate/scale/...) ---
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
        mi = np.diag(np.array([1.0 / x, 1.0 / y, 1.0 / z, 1.0], dtype=np.float32))
        return Transform(m, mi)

    @staticmethod
    def rotate_x(deg) -> "Transform":
        return Transform._rot(deg, 0)

    @staticmethod
    def rotate_y(deg) -> "Transform":
        return Transform._rot(deg, 1)

    @staticmethod
    def rotate_z(deg) -> "Transform":
        return Transform._rot(deg, 2)

    @staticmethod
    def _rot(deg, axis) -> "Transform":
        t = np.deg2rad(float(deg))
        s, c = np.sin(t), np.cos(t)
        m = np.eye(4, dtype=np.float32)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return Transform(m, m.T.copy())

    @staticmethod
    def rotate(deg, ax, ay, az) -> "Transform":
        """Rotation about arbitrary axis (reference transform.rs rotate)."""
        a = np.array([ax, ay, az], dtype=np.float64)
        a = a / np.linalg.norm(a)
        t = np.deg2rad(float(deg))
        s, c = np.sin(t), np.cos(t)
        m = np.eye(4, dtype=np.float64)
        m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
        m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
        m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
        m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
        m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
        m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
        m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
        m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
        m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
        m = m.astype(np.float32)
        return Transform(m, m.T.copy())

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """Camera-to-world (reference transform.rs look_at)."""
        eye = np.asarray(eye, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = look - eye
        d = d / np.linalg.norm(d)
        right = np.cross(up / np.linalg.norm(up), d)
        nr = np.linalg.norm(right)
        if nr < 1e-12:
            # up parallel to viewing direction; pick an arbitrary right
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
        """Perspective projection (reference transform.rs perspective)."""
        persp = np.array(
            [[1, 0, 0, 0],
             [0, 1, 0, 0],
             [0, 0, far / (far - near), -far * near / (far - near)],
             [0, 0, 1, 0]], dtype=np.float32)
        inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)

    @staticmethod
    def orthographic(near, far) -> "Transform":
        return Transform.scale(1.0, 1.0, 1.0 / (far - near)) * \
            Transform.translate(0.0, 0.0, -near)

    # --- host-side apply (numpy) ---
    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float32)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return r / w[..., None] if not np.allclose(w, 1.0) else r

    def apply_vector(self, v):
        v = np.asarray(v, dtype=np.float32)
        return v @ self.m[:3, :3].T

    def apply_normal(self, n):
        n = np.asarray(n, dtype=np.float32)
        return n @ self.m_inv[:3, :3]


def apply_mat3(m, x, y, z):
    """Rows of m[..., :3, :3] applied to the components (x, y, z); ``m``
    is one (4, 4) tensor or one per lane (..., 4, 4)."""
    return (m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
            m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
            m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z)


def xform_point(m, p):
    """Apply m ((4, 4) or (..., 4, 4)) to points (..., 3), with the divide
    by w."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx, ry, rz = apply_mat3(m, x, y, z)
    rx = rx + m[..., 0, 3]
    ry = ry + m[..., 1, 3]
    rz = rz + m[..., 2, 3]
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    inv_w = 1.0 / w
    return torch.stack([rx * inv_w, ry * inv_w, rz * inv_w], dim=-1)


def xform_vector(m, v):
    return torch.stack(apply_mat3(m, v[..., 0], v[..., 1], v[..., 2]), dim=-1)


def xform_normal(m_inv, n):
    """Normals transform by the inverse transpose: ``m_inv``'s columns."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [m_inv[..., 0, 0] * x + m_inv[..., 1, 0] * y + m_inv[..., 2, 0] * z,
         m_inv[..., 0, 1] * x + m_inv[..., 1, 1] * y + m_inv[..., 2, 1] * z,
         m_inv[..., 0, 2] * x + m_inv[..., 1, 2] * y + m_inv[..., 2, 2] * z],
        dim=-1)
