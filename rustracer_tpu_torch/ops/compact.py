"""Alive-first wavefront compaction: hand kernels K6 (``alive_first_order``)
and K7 (``slab_take`` / ``slab_put``) in csrc/compact.cu, with their plain
PyTorch versions (the forward passes of the reference's path.py compaction:
``argsort(~alive)``, ``argsort(order)``, ``perm_take`` and ``perm_put``).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from .. import cuda

# bytes per lane K7 moves -> the alignment its accesses need: a byte, a
# word, a long, or three words
_LANE_BYTES = {1: 1, 4: 4, 8: 8, 12: 4}


def alive_first_order_plain(alive):
    """-> (order (B,) int32: alive lanes first, each group in lane order;
    rank (B,) int32: each lane's position in order; n_alive () int32)."""
    order = torch.argsort((~alive).to(torch.uint8), stable=True)
    rank = torch.argsort(order)
    return (order.int(), rank.int(), alive.sum(dtype=torch.int32))


# lanes of one K6 tile (csrc/compact.cu kTileLanes)
K6_TILE_LANES = 2048
_K6_STATUS = {}   # (device, stream) -> K6's status words, 0 between launches


def _k6_status(dev, n):
    """K6's status words for ``n`` lanes on the current stream of ``dev``:
    zeroed when first made (or grown); each launch leaves them at 0 for the
    next launch on that stream."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    need = -(-n // K6_TILE_LANES) + 1
    status = _K6_STATUS.get(key)
    if status is None or status.shape[0] < need:
        status = torch.zeros(need, dtype=torch.int32, device=dev)
        _K6_STATUS[key] = status
    return status


def alive_first_order(alive):
    """The stable alive-first partition of ``alive`` (B,) bool. CPU tensors
    take the plain version, CUDA tensors launch K6 (a prefix sum, one
    launch)."""
    if not cuda.use_kernel(alive):
        return alive_first_order_plain(alive)
    n = alive.shape[0]
    dev = alive.device
    cuda.check(alive, "alive", torch.bool, (n,), dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if not n:
        return order, rank, torch.zeros((), dtype=torch.int32, device=dev)
    n_alive = torch.empty((), dtype=torch.int32, device=dev)
    cuda.launch("alive_first_order", alive, n, order, rank, n_alive,
                _k6_status(dev, n))
    return order, rank, n_alive


def _lane_bytes(t):
    b = t.element_size() * math.prod(t.shape[1:])
    if b not in _LANE_BYTES:
        raise ValueError(f"slab field of {b} bytes per lane: K7 moves "
                         f"{sorted(_LANE_BYTES)}")
    return b


def slab_move(name, order, w, full: Sequence[torch.Tensor],
              slab: Sequence[torch.Tensor], lib=None):
    """Launch K7 (``name``: "slab_take" or "slab_put") between full-width
    fields and their w-lane slabs; ``lib``: another build (cuda.launch)."""
    n = order.shape[0]
    dev = order.device
    if not 0 <= w <= n:
        raise ValueError(f"slab width {w} outside [0, {n}]")
    if len(full) != len(slab) or len(full) > 16:
        raise ValueError("K7 moves one slab per field, at most 16 fields")
    cuda.check(order, "order", torch.int32, (n,), dev)
    for f, s in zip(full, slab):
        align = _LANE_BYTES[_lane_bytes(f)]
        cuda.check(f, name, f.dtype, (n,) + tuple(f.shape[1:]), dev, align)
        cuda.check(s, name, f.dtype, (w,) + tuple(f.shape[1:]), dev, align)
    put = name == "slab_put"
    src, dst = (slab, full) if put else (full, slab)
    k = len(full)
    src_p = (ctypes.c_longlong * k)(*[t.data_ptr() for t in src])
    dst_p = (ctypes.c_longlong * k)(*[t.data_ptr() for t in dst])
    size = (ctypes.c_int * k)(*[_lane_bytes(t) for t in full])
    if w:
        cuda.launch(name, order, w, k, ctypes.addressof(src_p),
                    ctypes.addressof(dst_p), ctypes.addressof(size), lib=lib)


def slab_take_plain(fields, order, w):
    sel = order[:w].long()
    return [f[sel] for f in fields]


def slab_put_plain(fields, subs, order, w):
    sel = order[:w].long()
    for f, s in zip(fields, subs):
        f[sel] = s
    return fields


def slab_take(fields: List[torch.Tensor], order, w: int):
    """New (w, ...) tensors holding lanes order[:w] of every field. CPU
    tensors take the plain version, CUDA tensors launch K7 once."""
    if not cuda.use_kernel(order):
        return slab_take_plain(fields, order, w)
    subs = [torch.empty((w,) + tuple(f.shape[1:]), dtype=f.dtype,
                        device=f.device) for f in fields]
    slab_move("slab_take", order, w, fields, subs)
    return subs


def slab_put(fields: List[torch.Tensor], subs: List[torch.Tensor], order,
             w: int):
    """Write slab lanes ``subs`` back to lanes order[:w] of ``fields``, in
    place; returns ``fields``. CPU tensors take the plain version, CUDA
    tensors launch K7 once."""
    if not cuda.use_kernel(order):
        return slab_put_plain(fields, subs, order, w)
    slab_move("slab_put", order, w, fields, subs)
    return fields
