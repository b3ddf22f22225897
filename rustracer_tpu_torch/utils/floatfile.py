"""Whitespace/comment-tolerant float file reader.

Reference: rustracer-core/src/floatfile.rs (used for SPD & Fourier tables).
"""
from __future__ import annotations


def read_float_file(path: str):
    vals = []
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0]
            for tok in line.split():
                vals.append(float(tok))
    return vals
