"""Procedural meshes (port of rustracer_tpu/utils/meshgen.py: icosphere and
the bumpy sphere that stands in for the dragon scan). Same arithmetic, so
both packages generate the same vertices."""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions=3, radius=1.0):
    """Subdivided icosahedron -> (verts (V, 3) f32, faces (T, 3) i32),
    4^s * 20 triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = 0.5 * (np.asarray(verts_list[a]) + np.asarray(verts_list[b]))
                m /= np.linalg.norm(m)
                verts_list.append(m.tolist())
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
        verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    return (radius * verts).astype(np.float32), faces.astype(np.int32)


def bumpy_sphere(subdivisions=5, radius=1.0, bump_freq=8.0, bump_amp=0.15):
    """Icosphere displaced by layered trig noise -> (verts, area-weighted
    vertex normals, faces)."""
    v, f = icosphere(subdivisions, 1.0)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    disp = (np.sin(bump_freq * x) * np.cos(bump_freq * y)
            + 0.5 * np.sin(2.3 * bump_freq * y + 1.7) * np.cos(1.9 * bump_freq * z)
            + 0.25 * np.sin(4.1 * bump_freq * z + 0.3) * np.cos(3.7 * bump_freq * x))
    r = radius * (1.0 + bump_amp * disp / 1.75)[:, None]
    verts = (v * r).astype(np.float32)
    p0, p1, p2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    n = np.zeros_like(verts)
    np.add.at(n, f[:, 0], fn)
    np.add.at(n, f[:, 1], fn)
    np.add.at(n, f[:, 2], fn)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    return verts, n.astype(np.float32), f
