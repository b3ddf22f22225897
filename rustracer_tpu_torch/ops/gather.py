"""Row gather ``out[i] = table[idx[i]]`` and its hand kernel K8
(csrc/gather.cu), the port of tools/bench_gather_pallas.py ``pallas_gather``,
with its backward, hand kernel K11 (csrc/gather_bwd.cu): the sum of the
row gradients into the table's gradient.

K8 copies float4s with neighbouring threads on neighbouring addresses; a
128-float (512-byte) BVH row is one warp. The render uses it for the
per-material parameter rows of ``MaterialSet.shade``; the microbenchmark
``rustracer_tpu_torch.tools.bench_gather`` times it on BVH-sized rows.
"""
from __future__ import annotations

import torch

from .. import cuda

MAX_ROWS = (1 << 31) - 1
# floats of a table gradient that K11 sums in one block's shared memory: a
# table beyond its register path (more than 8 rows, or a row that is not
# 1, 2, 4 or 8 float4s) must fit
K11_MAX_FLOATS = 12288
# K11's fold counter: one word for each (device, stream), zeroed when made;
# each launch leaves it at 0
_K11_COUNTER = {}


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
    CPU tensors take the plain version, CUDA tensors launch K8. A table
    that requires grad (grad mode on) goes through an autograd Function
    whose backward is ``row_gather_bwd``."""
    _check(table, idx)
    if table.requires_grad and torch.is_grad_enabled():
        return _RowGather.apply(table, idx)
    if not cuda.use_kernel(table):
        return row_gather_plain(table, idx)
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if n:
        cuda.launch("row_gather", table, idx, n, table.shape[1], out)
    return out


def row_gather_bwd_plain(g, idx, rows):
    """Plain PyTorch version of K11: ``zeros(R, W).index_add_(0, idx, g)``."""
    return torch.zeros((rows, g.shape[1]), dtype=g.dtype,
                       device=g.device).index_add_(0, idx.long(), g)


def _k11_counter(dev):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    counter = _K11_COUNTER.get(key)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _K11_COUNTER[key] = counter
    return counter


def row_gather_bwd(g, idx, rows):
    """The table gradient (R, W) of ``row_gather``: row gradients ``g``
    (B, W) summed into the rows ``idx`` (B,) int32 they came from. CPU
    tensors take the plain version, CUDA tensors launch K11: a table of at
    most 8 rows of 4, 8, 16 or 32 floats is summed in registers and folded
    in a fixed order (the same bits from launch to launch); a larger one
    (R * W at most K11_MAX_FLOATS) in each block's shared memory, added
    into the output with one atomic an entry."""
    if not cuda.use_kernel(g):
        return row_gather_bwd_plain(g, idx, rows)
    n, width = g.shape
    dev = g.device
    cuda.check(g, "g", torch.float32, (n, width), dev)
    cuda.check(idx, "idx", torch.int32, (n,), dev)
    blocks = cuda.host_call("row_gather_bwd_blocks", n, rows, width)
    if not blocks and not 0 < rows * width <= K11_MAX_FLOATS:
        raise ValueError(f"row_gather_bwd: a {rows} x {width} table gradient "
                         f"exceeds the {K11_MAX_FLOATS} floats K11 sums in "
                         "shared memory")
    if not n:
        return torch.zeros((rows, width), dtype=torch.float32, device=dev)
    if blocks and g.data_ptr() % 16:
        g = g.clone()    # the register path reads float4s
    out = torch.empty((rows, width), dtype=torch.float32, device=dev)
    partials = torch.empty(blocks * rows * width, dtype=torch.float32,
                           device=dev)
    cuda.launch("row_gather_bwd", g, idx, n, rows, width, out, partials,
                _k11_counter(dev))
    return out


class _RowGather(torch.autograd.Function):
    """K8 forward, K11 backward (gradient to the table only)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        with cuda.differentiable():
            return row_gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        with cuda.differentiable():
            return row_gather_bwd(g.contiguous(), idx, ctx.rows), None
