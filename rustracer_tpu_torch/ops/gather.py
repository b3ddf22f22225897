"""Row gather ``out[i] = table[idx[i]]`` and its hand kernel K8
(csrc/gather.cu), the port of tools/bench_gather_pallas.py ``pallas_gather``.

K8 copies float4s with neighbouring threads on neighbouring addresses; a
128-float (512-byte) BVH row is one warp. The render uses it for the
per-material parameter rows of ``MaterialSet.shade``; the microbenchmark
``rustracer_tpu_torch.tools.bench_gather`` times it on BVH-sized rows.
"""
from __future__ import annotations

import torch

from .. import cuda

MAX_ROWS = (1 << 31) - 1


def row_gather_plain(table, idx):
    """Plain PyTorch version of K8: ``table[idx]``."""
    return table[idx.long()]


def _check(table, idx):
    if not isinstance(table, torch.Tensor) or table.dim() != 2:
        raise ValueError("table: expected a 2-D tensor")
    if not isinstance(idx, torch.Tensor) or idx.dim() != 1:
        raise ValueError("idx: expected a 1-D tensor")
    rows, width = table.shape
    if width == 0 or width % 4:
        raise ValueError(f"table: row width {width} is not a positive "
                         "multiple of 4 floats")
    if not 0 < rows <= MAX_ROWS or idx.shape[0] > MAX_ROWS:
        raise ValueError(f"table rows {rows} and gathers {idx.shape[0]} "
                         f"must lie in [1, {MAX_ROWS}]")
    cuda.check(table, "table", torch.float32, (rows, width), table.device,
               align=16)
    cuda.check(idx, "idx", torch.int32, (idx.shape[0],), table.device)


def row_gather(table, idx):
    """Rows ``idx`` (B,) int32 of ``table`` (R, W) float32, W a multiple of
    4, both contiguous on one device; every index must lie in [0, R).
    CPU tensors take the plain version, CUDA tensors launch K8."""
    _check(table, idx)
    if not cuda.use_kernel(table):
        return row_gather_plain(table, idx)
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if n:
        cuda.launch("row_gather", table, idx, n, table.shape[1], out)
    return out
