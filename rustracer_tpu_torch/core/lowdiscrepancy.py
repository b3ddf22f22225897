"""Scrambled (0,2)-sequence points (port of rustracer_tpu/core/lowdiscrepancy.py).

Sample i is evaluated directly: dimension 0 is the bit-reversed index (van
der Corput), dimension 1 the Pascal-matrix Sobol' component, each XOR-
scrambled. uint32 words travel as int64 values in [0, 2^32) (see core/rng).
"""
from __future__ import annotations

import numpy as np
import torch

from .rng import MASK32, as_u32, bits_to_float

# Pascal matrix mod 2 columns: col[j] has bit (31-i) set iff C(j, i) is odd,
# i.e. (i & j) == i (Lucas' theorem).
PASCAL_COLS = np.zeros(32, dtype=np.int64)
for _j in range(32):
    for _i in range(_j + 1):
        if (_i & _j) == _i:
            PASCAL_COLS[_j] |= 1 << (31 - _i)


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = as_u32(x)
    x = ((x << 16) | (x >> 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    return ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)


def van_der_corput(index: torch.Tensor, scramble) -> torch.Tensor:
    """Scrambled van der Corput sample for an integer index batch."""
    return bits_to_float(reverse_bits32(index) ^ as_u32(scramble,
                                                        index.device))


def sobol_dim2(index: torch.Tensor, scramble) -> torch.Tensor:
    """Second component of the 2D Sobol'/(0,2) sequence (Pascal matrix)."""
    index = as_u32(index)
    out = torch.zeros_like(index)
    for k in range(32):
        take = ((index >> k) & 1) != 0
        out = torch.where(take, out ^ int(PASCAL_COLS[k]), out)
    return bits_to_float(out ^ as_u32(scramble, index.device))


def sample02(index: torch.Tensor, scramble2) -> torch.Tensor:
    """(0,2)-sequence 2D point for sample ``index`` -> (..., 2)."""
    return torch.stack([van_der_corput(index, scramble2[0]),
                        sobol_dim2(index, scramble2[1])], dim=-1)
