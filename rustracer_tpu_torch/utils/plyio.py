"""PLY mesh loader (ascii + binary little/big endian).

Reference: rustracer-core/src/shapes/plymesh.rs:18-242 (via the ply-rs
crate). Hand-rolled reader supporting the vertex properties the reference
consumes: x/y/z, nx/ny/nz, u/v (or s/t), and triangle/quad face lists
(quads split into two tris).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_TYPE_MAP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray],
                                 Optional[np.ndarray], np.ndarray]:
    """→ (positions (V,3), normals (V,3) | None, uv (V,2) | None,
    indices (T,3) int32)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []   # (name, count, [(prop_name, dtype, is_list, idx_t, cnt_t)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(
                        (parts[4], None, True, _TYPE_MAP[parts[2]],
                         _TYPE_MAP[parts[3]]))
                else:
                    elements[-1][2].append(
                        (parts[2], _TYPE_MAP[parts[1]], False, None, None))
            elif parts[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        verts = {}
        faces = []
        tri_blocks = []     # pre-triangulated (K, 3) blocks (fast path)
        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if name == "vertex":
                    arr = np.array([[float(x) for x in r[:len(props)]]
                                    for r in rows], np.float32)
                    for i, (pname, *_rest) in enumerate(props):
                        verts[pname] = arr[:, i]
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        faces.append([int(x) for x in r[1:1 + n]])
            else:
                if not any(p[2] for p in props):
                    # fixed-size element: bulk read
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    if name == "vertex":
                        for p in props:
                            verts[p[0]] = data[p[0]].astype(np.float32)
                elif (name == "face" and len(props) == 1 and props[0][2]
                      and count > 0):
                    # fast path: single list property, uniform count per row
                    # (every real mesh). Peek the first row's count, bulk-
                    # parse at fixed stride, verify; else rewind to the
                    # row-loop fallback.
                    pname, _, _, idx_t, cnt_t = props[0]
                    cdt = np.dtype(endian + idx_t)
                    vdt = np.dtype(endian + cnt_t)
                    pos = f.tell()
                    nper = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                    f.seek(pos)
                    stride = cdt.itemsize + nper * vdt.itemsize
                    buf = f.read(stride * count)
                    # mixed-size rows make the bulk read come up short (e.g.
                    # quad-first then tris) or let index bytes land in the
                    # count slot; accept the fast path only when the length
                    # matches, every count agrees, AND all indices are valid
                    vals = None
                    if len(buf) == stride * count:
                        rdt = np.dtype([("n", endian + idx_t),
                                        ("v", endian + cnt_t, (nper,))])
                        data = np.frombuffer(buf, rdt, count)
                        nv = verts["x"].shape[0] if "x" in verts else None
                        if (data["n"] == nper).all():
                            v = data["v"]
                            if nv is None or (
                                    (v.min(initial=0) >= 0)
                                    and (v.max(initial=-1) < nv)):
                                vals = v
                    if vals is not None:
                        if nper == 3:
                            tri_blocks.append(np.asarray(vals, np.int32))
                        else:
                            for row in vals:
                                faces.append(list(row))
                    else:
                        # ragged counts: re-read row by row
                        f.seek(pos)
                        for _ in range(count):
                            n = int(np.frombuffer(f.read(cdt.itemsize),
                                                  cdt)[0])
                            vals = np.frombuffer(f.read(vdt.itemsize * n),
                                                 vdt)
                            faces.append(list(vals))
                else:
                    # list properties (faces): per-row read
                    for _ in range(count):
                        row_vals = []
                        for pname, dtype, is_list, idx_t, cnt_t in props:
                            if is_list:
                                cdt = np.dtype(endian + idx_t)
                                n = int(np.frombuffer(f.read(cdt.itemsize),
                                                      cdt)[0])
                                vdt = np.dtype(endian + cnt_t)
                                vals = np.frombuffer(f.read(vdt.itemsize * n),
                                                     vdt)
                                row_vals.append(vals)
                            else:
                                vdt = np.dtype(endian + dtype)
                                row_vals.append(
                                    np.frombuffer(f.read(vdt.itemsize), vdt)[0])
                        if name == "face":
                            faces.append(list(row_vals[0]))

    if not {"x", "y", "z"} <= verts.keys():
        raise ValueError(f"{path}: PLY has no x/y/z vertex positions")
    p = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
    n = None
    if {"nx", "ny", "nz"} <= verts.keys():
        n = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1).astype(np.float32)
    uv = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if {ukey, vkey} <= verts.keys():
            uv = np.stack([verts[ukey], verts[vkey]], -1).astype(np.float32)
            break
    idx = []
    for face in faces:
        for k in range(1, len(face) - 1):   # fan-triangulate
            idx.append((face[0], face[k], face[k + 1]))
    idx = np.asarray(idx, np.int32).reshape(-1, 3)
    if tri_blocks:
        idx = np.concatenate([idx] + tri_blocks) if len(idx) else \
            np.concatenate(tri_blocks)
    return p, n, uv, idx


def write_ply(path: str, p: np.ndarray, idx: np.ndarray,
              n: Optional[np.ndarray] = None,
              uv: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write a triangle mesh as PLY (binary little-endian or ascii).

    Exporter counterpart to read_ply (the reference only reads,
    plymesh.rs:18-242); used by tests and by bench.py to exercise the
    loader at benchmark scale."""
    p = np.asarray(p, np.float32)
    idx = np.asarray(idx, np.int32).reshape(-1, 3)
    cols = [("x", p[:, 0]), ("y", p[:, 1]), ("z", p[:, 2])]
    if n is not None:
        n = np.asarray(n, np.float32)
        cols += [("nx", n[:, 0]), ("ny", n[:, 1]), ("nz", n[:, 2])]
    if uv is not None:
        uv = np.asarray(uv, np.float32)
        cols += [("u", uv[:, 0]), ("v", uv[:, 1])]
    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0",
              f"element vertex {p.shape[0]}"]
    header += [f"property float {name}" for name, _ in cols]
    header += [f"element face {idx.shape[0]}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        vdata = np.stack([c for _, c in cols], -1).astype("<f4")
        fdata = np.empty((idx.shape[0],),
                         np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
        fdata["n"] = 3
        fdata["v"] = idx
        if binary:
            f.write(vdata.tobytes())
            f.write(fdata.tobytes())
        else:
            for row in vdata:
                f.write((" ".join(repr(float(x)) for x in row) + "\n")
                        .encode("ascii"))
            for tri in idx:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))
