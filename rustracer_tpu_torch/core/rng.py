"""Counter-based hashing RNG (port of rustracer_tpu/core/rng.py).

Every lane derives its random numbers from (seed, pixel, sample, dimension)
with no sequential state, so no ``torch.Generator`` sits on the render path.

PyTorch supports uint32 arithmetic only in part, so the uint32 words are
carried in int64 tensors holding values in [0, 2^32): every product and
shift is masked back to 32 bits, and shifts of such values are logical. The
results are bit-equal to the JAX package's uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_INV_2_32 = float(np.float32(2.0 ** -32))
_ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def as_u32(x, device=None) -> torch.Tensor:
    """Python int or integer tensor -> int64 tensor of uint32 values."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer on uint32 words."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def hash_u32(*words) -> torch.Tensor:
    """Combine uint32 words (ints or int64 tensors) into one mixed word."""
    device = next((w.device for w in words if isinstance(w, torch.Tensor)),
                  None)
    h = as_u32(0x9E3779B9, device)
    for w in words:
        h = (_mix(h ^ as_u32(w, device)) + 0x7F4A7C15) & MASK32
    return _mix(h)


def bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1): the conversion rounds to nearest
    even, as ``astype(float32)`` does, then scales by 2^-32 and clamps."""
    f = bits.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=_ONE_MINUS_EPS)


def hash_float(*words) -> torch.Tensor:
    """Uniform float32 in [0, 1) from hashed words."""
    return bits_to_float(hash_u32(*words))
