"""Alive-first wavefront compaction: hand kernels K6 (``alive_first_order``)
and K7 (``slab_take`` / ``slab_put``) in csrc/compact.cu, with their plain
PyTorch versions (the forward passes of the reference's path.py compaction:
``argsort(~alive)``, ``argsort(order)``, ``perm_take`` and ``perm_put``).

Under autograd (grad mode on, a field or slab requiring grad) the moves are
autograd Functions whose backward passes are K7 again, as the reference's
``custom_vjp``s define them (rustracer_tpu/integrators/path.py:54-105):
order is a permutation, so the transpose of a take is a put of the slab's
gradient into full-width zeros, and the transpose of a put is a take of
the gradient for the slab and, for the full width, the gradient with the
slab's lanes zeroed (a put of zeros).
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
    cuda.check_grad(name, list(full) + list(slab))
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


def _needs_graph(tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def slab_take(fields: List[torch.Tensor], order, w: int):
    """New (w, ...) tensors holding lanes order[:w] of every field. CPU
    tensors take the plain version, CUDA tensors launch K7 once; through
    an autograd Function (backward: K7's put) when a field requires
    grad."""
    if _needs_graph(fields):
        return list(_SlabTake.apply(order, w, *fields))
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
    tensors launch K7 once; through an autograd Function (marking the
    fields dirty; backward: K7's take and put) when a field or a slab
    requires grad."""
    if _needs_graph(list(fields) + list(subs)):
        return list(_SlabPut.apply(order, w, len(fields), *fields, *subs))
    if not cuda.use_kernel(order):
        return slab_put_plain(fields, subs, order, w)
    slab_move("slab_put", order, w, fields, subs)
    return fields


def take_transpose(order, w, g_subs, shapes):
    """The gradients of the fields of a ``slab_take`` from those of its
    slabs ``g_subs`` (w, ...): each slab's gradient put into full-width
    zeros of ``shapes`` [(shape, dtype)] (one K7 put for all)."""
    g_full = [torch.zeros(shape, dtype=dtype, device=order.device)
              for shape, dtype in shapes]
    slab_put(g_full, [g.contiguous() for g in g_subs], order, w)
    return g_full


def put_transpose(order, w, g_full):
    """The gradients of a ``slab_put`` from those of its fields ``g_full``:
    -> (the slabs' gradients, K7's take of ``g_full``; the fields'
    gradients, ``g_full`` with the slab's lanes zeroed by a K7 put of
    zeros)."""
    g_full = [g.contiguous() for g in g_full]
    g_subs = slab_take(g_full, order, w)
    g_kept = [g.clone() for g in g_full]
    slab_put(g_kept, [torch.zeros_like(g) for g in g_subs], order, w)
    return g_subs, g_kept


def _or_zeros(grads, shapes, device):
    """``grads`` with None replaced by zeros of ``shapes``."""
    return [torch.zeros(shape, dtype=dtype, device=device) if g is None
            else g for g, (shape, dtype) in zip(grads, shapes)]


class _SlabTake(torch.autograd.Function):
    """K7's take; backward: K7's put into zeros (take_transpose)."""

    @staticmethod
    def forward(ctx, order, w, *fields):
        with cuda.differentiable():
            subs = slab_take(list(fields), order, w)
        ctx.save_for_backward(order)
        ctx.w = w
        ctx.shapes = [(f.shape, f.dtype) for f in fields]
        # a slab of a field without a gradient carries none: K1 and K2
        # must not be handed it as a tensor that requires grad
        ctx.mark_non_differentiable(*[s for s, f in zip(subs, fields)
                                      if not f.requires_grad])
        return tuple(subs)

    @staticmethod
    def backward(ctx, *g_subs):
        (order,) = ctx.saved_tensors
        need = [i for i, n in enumerate(ctx.needs_input_grad[2:]) if n]
        grads = [None] * len(ctx.shapes)
        if need:
            shapes = [ctx.shapes[i] for i in need]
            subs = _or_zeros([g_subs[i] for i in need],
                             [((ctx.w,) + tuple(s[1:]), d) for s, d in shapes],
                             order.device)
            with cuda.differentiable():
                g_full = take_transpose(order, ctx.w, subs, shapes)
            for i, g in zip(need, g_full):
                grads[i] = g
        return (None, None, *grads)


class _SlabPut(torch.autograd.Function):
    """K7's put in place; backward: K7's take and a put of zeros
    (put_transpose)."""

    @staticmethod
    def forward(ctx, order, w, k, *tensors):
        fields, subs = list(tensors[:k]), list(tensors[k:])
        with cuda.differentiable():
            slab_put(fields, subs, order, w)
        ctx.mark_dirty(*fields)
        ctx.mark_non_differentiable(*[
            f for f, s in zip(fields, subs)
            if not (f.requires_grad or s.requires_grad)])
        ctx.save_for_backward(order)
        ctx.w, ctx.k = w, k
        ctx.shapes = [(f.shape, f.dtype) for f in fields]
        return tuple(fields)

    @staticmethod
    def backward(ctx, *g_full):
        (order,) = ctx.saved_tensors
        k = ctx.k
        need_f = ctx.needs_input_grad[3:3 + k]
        need_s = ctx.needs_input_grad[3 + k:]
        need = [i for i in range(k) if need_f[i] or need_s[i]]
        grads = [None] * (2 * k)
        if need:
            g = _or_zeros([g_full[i] for i in need],
                          [ctx.shapes[i] for i in need], order.device)
            with cuda.differentiable():
                g_subs, g_kept = put_transpose(order, ctx.w, g)
            for j, i in enumerate(need):
                grads[i] = g_kept[j] if need_f[i] else None
                grads[k + i] = g_subs[j] if need_s[i] else None
        return (None, None, None, *grads)
