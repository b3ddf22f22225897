"""Stateless per-lane samplers (port of rustracer_tpu/render/sampler.py)
and their hand kernels K3 and K3r.

The (0,2)-sequence sampler: dimension ``dim`` of sample ``s`` at pixel
``p`` is the scrambled (0,2) point ``s`` with XOR scrambles
``hash_u32(seed, p, dim, salt)``. The random sampler: hashed uniforms,
``hash_float(seed, p, s, dim)`` in 1D and ``hash_float(seed, p, s, dim,
k)``, k = 0, 1, in 2D. Nothing is carried between calls. Pixel and sample
indices are int64 tensors holding uint32 values (see core/rng).

K3 (csrc/sampler.cu, ``sample_1d`` / ``sample_2d``) replaces ``get_1d``
(rustracer_tpu/render/sampler.py:34) and ``get_2d`` (:40) with their hash and
(0,2) chains from core/rng.py and core/lowdiscrepancy.py. It is bit-exact
with the plain versions below. One thread per lane: two int64 loads and one
or two float stores, a few dozen integer operations, so the kernel is bound
by memory traffic; it fuses what the plain version spends some 130 tensor
passes on (the 32-step Sobol' loop alone is 96). K3r (csrc/sampler.cu,
``sample_random_1d`` / ``sample_random_2d``) replaces the random branches
(rustracer_tpu/render/sampler.py:35-36, :41-44) the same way, bit-exact
with ``get_random_1d_plain`` / ``get_random_2d_plain``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..core.lowdiscrepancy import sample02, van_der_corput
from ..core.rng import MASK32, hash_float, hash_u32

SALT_1D = 0x1D
SALT_2D_X = 0x2D0
SALT_2D_Y = 0x2D1


def get_1d_plain(seed: int, pixel_idx, sample_idx, dim: int):
    scr = hash_u32(seed, pixel_idx, dim, SALT_1D)
    return van_der_corput(sample_idx, scr)


def get_2d_plain(seed: int, pixel_idx, sample_idx, dim: int):
    sx = hash_u32(seed, pixel_idx, dim, SALT_2D_X)
    sy = hash_u32(seed, pixel_idx, dim, SALT_2D_Y)
    return sample02(sample_idx, (sx, sy))


def get_random_1d_plain(seed: int, pixel_idx, sample_idx, dim: int):
    return hash_float(seed, pixel_idx, sample_idx, dim)


def get_random_2d_plain(seed: int, pixel_idx, sample_idx, dim: int):
    return torch.stack([hash_float(seed, pixel_idx, sample_idx, dim, k)
                        for k in (0, 1)], dim=-1)


def _sample_kernel(name, width, seed, pixel_idx, sample_idx, dim):
    n = pixel_idx.shape[0]
    for t, nm in ((pixel_idx, "pixel_idx"), (sample_idx, "sample_idx")):
        cuda.check(t, nm, torch.int64, (n,), pixel_idx.device)
    out = torch.empty((n, width) if width > 1 else (n,),
                      dtype=torch.float32, device=pixel_idx.device)
    if n:
        cuda.launch(name, pixel_idx, sample_idx, n, seed & MASK32,
                    dim & MASK32, out)
    return out


SEQUENCE_KINDS = ("02sequence", "lowdiscrepancy", "zerotwosequence")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "02sequence"   # one of SEQUENCE_KINDS, or "random"
    spp: int = 16
    seed: int = 0

    def __post_init__(self):
        if self.kind not in SEQUENCE_KINDS + ("random",):
            raise ValueError(f"sampler {self.kind!r}: expected one of "
                             f"{SEQUENCE_KINDS + ('random',)}")
        if self.kind in SEQUENCE_KINDS:
            # round spp up to a power of two (zerotwosequence.rs:30)
            spp = 1 << int(np.ceil(np.log2(max(1, self.spp))))
            object.__setattr__(self, "spp", spp)

    def get_1d(self, pixel_idx, sample_idx, dim: int):
        """(B,) int64 pixel and sample indices -> (B,) float32."""
        rand = self.kind == "random"
        if cuda.use_kernel(pixel_idx):
            return _sample_kernel("sample_random_1d" if rand else "sample_1d",
                                  1, self.seed, pixel_idx, sample_idx, dim)
        plain = get_random_1d_plain if rand else get_1d_plain
        return plain(self.seed, pixel_idx, sample_idx, dim)

    def get_2d(self, pixel_idx, sample_idx, dim: int):
        """(B,) int64 pixel and sample indices -> (B, 2) float32."""
        rand = self.kind == "random"
        if cuda.use_kernel(pixel_idx):
            return _sample_kernel("sample_random_2d" if rand else "sample_2d",
                                  2, self.seed, pixel_idx, sample_idx, dim)
        plain = get_random_2d_plain if rand else get_2d_plain
        return plain(self.seed, pixel_idx, sample_idx, dim)

    def get_camera_sample(self, pixel_xy, pixel_idx, sample_idx):
        """-> (p_film (B, 2), p_lens (B, 2), time (B,)): 2D dims 0 (film
        jitter) and 1 (lens), 1D dim 0 (time)."""
        p_film = pixel_xy + self.get_2d(pixel_idx, sample_idx, 0)
        p_lens = self.get_2d(pixel_idx, sample_idx, 1)
        time = self.get_1d(pixel_idx, sample_idx, 0)
        return p_film, p_lens, time


class DimAllocator:
    """Hands out sampler dimensions in order; 2D dims 0-1 and 1D dim 0 are
    the camera sample's."""

    def __init__(self, start2d=2, start1d=1):
        self.d2 = start2d
        self.d1 = start1d

    def next_2d(self):
        self.d2 += 1
        return self.d2 - 1

    def next_1d(self):
        self.d1 += 1
        return self.d1 - 1
