"""Inverse rendering and the sharded render over torch.distributed (port
of rustracer_tpu/parallel/mesh.py).

One device: ``make_train_step`` renders one sample index over every pixel
into the film, takes ``loss = mean((to_image(film) - target)^2)``,
differentiates it with respect to the float leaves of ``ctx.textures``
(the constant kd vectors and every pyramid level; the int32 atlas
metadata rides along) and applies SGD. The gradient runs through the hand
kernels' autograd Functions: K4's backward K9, K5's K10, K8's K11, K17's
K20 (the per-texture image lookups) and K7 as its own transpose. A scene
whose materials hold a Fourier BSDF (K19, no backward yet: ROADMAP.md,
section B, item B11b) is refused when the step is built; a step whose
gradient would run through a sampled ray direction or a texture lookup's
coordinates raises when it gets there (item B12).

Several ranks (the reference's tile threads, renderer.rs:56-76, as
processes of one default process group: parallel/launch.py joins them):
``make_device_mesh`` lays the ranks out as a ("data", "sample") mesh, rank
r at (d, s) = divmod(r, sample). ``make_sharded_render_step`` gives rank
(d, s) the contiguous block d of a global tile's lanes at sample
``sample_lo + s``, renders it through ``Renderer.step`` (K1-K8) into a
fresh film and all-reduces the film with SUM over the whole mesh (the
film merge under a mutex becomes a collective: NCCL on the card, gloo on
the CPU). ``render_sharded`` tiles the film's sample bounds as the JAX
package does. ``make_sharded_train_step`` differentiates through that
all-reduce, whose backward passes the gradient through unchanged (every
rank takes the same loss of the same summed film, so the gradient with
respect to a rank's own film is the gradient with respect to the sum),
then all-reduces the leaves' gradients with SUM in one flat buffer, where
a leaf that no lane of a rank reached joins as zeros. Every collective
runs on the default group, whose timeout ``launch.init_rank`` sets; no
counters are recorded on the sharded path (the JAX package records none
there).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..render.film import FilmState, _packed
from ..render.renderer import RenderConfig, Renderer


def float_leaves(tree):
    """-> (the float tensors of a pytree of dicts, lists, tuples
    (NamedTuples too) and tensors, in the order of jax.tree.flatten: dict
    keys sorted; rebuild(new) -> the tree with those leaves replaced by
    ``new``, in that order)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif isinstance(t, torch.Tensor) and t.is_floating_point():
            leaves.append(t)

    def rebuild(new):
        it = iter(new)

        def put(t):
            if isinstance(t, dict):
                return {k: put(t[k]) for k in sorted(t)}
            if hasattr(t, "_fields"):   # a NamedTuple: field by field
                return type(t)(*[put(x) for x in t])
            if isinstance(t, (list, tuple)):
                return type(t)(put(x) for x in t)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                return next(it)
            return t
        return put(tree)

    walk(tree)
    return leaves, rebuild


def check_differentiable(li_fn):
    """Raise NotImplementedError where the integrator of ``li_fn`` shades
    through a kernel without a backward: a Fourier BSDF (K19). The step is
    never run with such a gradient dropped."""
    from ..ops.bsdf import FOURIER
    mat_set = getattr(getattr(li_fn, "__self__", None), "mat_set", None)
    if mat_set is None:
        return
    if FOURIER in mat_set.types_present():
        raise NotImplementedError(
            "this train step: a gradient through the Fourier BSDF (hand "
            "kernel K19, which has no backward yet) is not ported yet "
            "(ROADMAP.md, section B, item B11b)")


def make_train_step(li_fn, camera, film, sampler, lr=0.1,
                    config: Optional[RenderConfig] = None, device="cuda"):
    """-> step(ctx, target, sample_lo=0) -> (new_ctx, loss (0-d tensor)):
    one SGD step of ``mean((render(ctx.textures) - target)^2)`` over sample
    ``sample_lo`` of every pixel, rendered by ``Renderer`` (``config``:
    its tiles) on ``device``. The new context carries new float leaves
    ``p - lr * grad``; a leaf the render does not reach keeps its value."""
    check_differentiable(li_fn)
    renderer = Renderer(li_fn, camera, film, sampler, config, device=device)

    def step(ctx, target, sample_lo: int = 0):
        leaves, rebuild = float_leaves(ctx.textures)
        theta = [p.detach().requires_grad_() for p in leaves]
        c = dataclasses.replace(ctx, textures=rebuild(theta))
        with torch.enable_grad():
            fs = renderer.render_state(c, sample_start=sample_lo,
                                       sample_stop=sample_lo + 1)
            loss = torch.mean((film.to_image(fs) - target) ** 2)
            grads = torch.autograd.grad(loss, theta, allow_unused=True)
        new = [p.detach() if g is None else (p - lr * g).detach()
               for p, g in zip(theta, grads)]
        return dataclasses.replace(ctx, textures=rebuild(new)), \
            loss.detach()

    return step


def grad_errors(grads, refs):
    """-> (||g - r|| / ||r||, max |g - r| / max |r|) over all the tensors
    of ``grads`` and ``refs`` together (a parity measure of gradients)."""
    g = torch.cat([t.detach().reshape(-1).double().cpu() for t in grads])
    r = torch.cat([t.detach().reshape(-1).double().cpu() for t in refs])
    norm, top = r.norm().item(), r.abs().max().item()
    d = g - r
    return (d.norm().item() / max(norm, 1e-300),
            d.abs().max().item() / max(top, 1e-300))


def make_device_mesh(data: int = 0, sample: int = 1, device="cuda"):
    """The ("data", "sample") DeviceMesh over every rank of the initialised
    default process group (``launch.init_rank``); ``data`` <= 0 fills what
    ``sample`` leaves. Rank r sits at (d, s) = divmod(r, sample), the JAX
    package's ``reshape(data, sample)``. Raises where the shape does not
    multiply to the world size, or where the group's backend cannot reduce
    tensors on ``device`` (NCCL takes the card only)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group; join one "
                           "with parallel/launch.py init_rank first")
    n = dist.get_world_size()
    if data <= 0:
        data = n // sample
    if data * sample != n:
        raise ValueError(f"mesh {data}x{sample} != {n} ranks")
    kind = torch.device(device).type
    if kind != "cuda" and dist.get_backend() == "nccl":
        raise ValueError(f"a mesh on {kind} over NCCL: NCCL reduces tensors "
                         "on the card only")
    return init_device_mesh(kind, (data, sample),
                            mesh_dim_names=("data", "sample"))


def _mesh_device(mesh):
    """The device this rank renders on: its current card for a mesh on
    the card, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _FilmSum(torch.autograd.Function):
    """The film's all-reduce, SUM over the whole mesh, out of place. Its
    backward passes the gradient through unchanged: every rank takes the
    same loss of the same summed film. (``torch.distributed.nn``'s
    all_reduce all-reduces in its backward too, which would scale the
    gradient by the world size before the leaves' own reduction.)"""

    @staticmethod
    def forward(ctx, acc):
        out = acc.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def film_all_reduce(fs: FilmState) -> FilmState:
    """The mesh's sum of every rank's film ``fs`` (the packed (H, W, 4)
    buffer of ``Film.init_state``), differentiable as ``_FilmSum``."""
    acc = _packed(fs)
    if acc is None:
        raise ValueError("film_all_reduce takes the packed film state of "
                         "Film.init_state")
    out = _FilmSum.apply(acc)
    return FilmState(rgb=out[..., :3], wsum=out[..., 3])


def all_reduce_grads(grads, params):
    """The gradients ``grads`` of ``params`` summed over the mesh in one
    flat buffer. A None (a leaf that no lane of this rank reached) joins
    as zeros, so every rank reduces a buffer of the same size."""
    if not params:
        return []
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for g, p in zip(grads, params)])
    dist.all_reduce(flat)
    return [g.view_as(p).to(p.dtype) for g, p in
            zip(torch.split(flat, [p.numel() for p in params]), params)]


def sample_lanes(film, multiple: int = 1):
    """The film's sample bounds as lanes, row-major, padded with invalid
    lanes at the first sample position to a multiple of ``multiple``
    -> (px, py int32, valid bool) numpy arrays."""
    x0, y0, x1, y1 = film.get_sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.int32),
                         np.arange(y0, y1, dtype=np.int32))
    px, py = gx.ravel(), gy.ravel()
    pad = (-px.size) % multiple
    valid = np.concatenate([np.ones(px.size, bool), np.zeros(pad, bool)])
    px = np.concatenate([px, np.full(pad, x0, np.int32)])
    py = np.concatenate([py, np.full(pad, y0, np.int32)])
    return px, py, valid


def _valid_count(v) -> int:
    if isinstance(v, torch.Tensor):
        return int(v.sum())
    return int(np.count_nonzero(v))


class _Shard:
    """This rank's part of a mesh: its coordinate (d, s) and the renderer
    whose ``step`` renders its lanes, in wavefronts of at most
    ``max_lanes`` (None: the whole block, as the JAX package)."""

    def __init__(self, li_fn, camera, film, sampler, mesh,
                 config: Optional[RenderConfig]):
        self.n_data, self.n_sample = tuple(mesh.shape)
        self.d, self.s = tuple(mesh.get_coordinate())
        self.device = _mesh_device(mesh)
        self.max_lanes = None if config is None else config.max_lanes
        self.renderer = Renderer(li_fn, camera, film, sampler,
                                 RenderConfig(collect_stats=False),
                                 device=self.device)

    def render(self, ctx, fs, px, py, valid, samples):
        """Add this rank's block d of the global lanes (px, py, valid) at
        each sample of ``samples`` into ``fs``; a wavefront without a
        valid lane is skipped."""
        n = len(px)
        if n % self.n_data:
            raise ValueError(f"{n} lanes do not split over the data axis "
                             f"({self.n_data})")
        blk = n // self.n_data
        lo, hi = self.d * blk, (self.d + 1) * blk
        w = self.max_lanes or blk
        for a in range(lo, hi, w):
            b = min(a + w, hi)
            if _valid_count(valid[a:b]) == 0:
                continue
            lanes = [torch.as_tensor(x[a:b], device=self.device)
                     for x in (px, py, valid)]
            for s in samples:
                fs = self.renderer.step(ctx, fs, lanes[0], lanes[1], int(s),
                                        lanes[2])
        return fs


def make_sharded_render_step(li_fn, camera, film, sampler, mesh):
    """-> step(ctx, px, py, valid, sample_lo=0) -> FilmState, the same on
    every rank. ``px``, ``py``, ``valid`` are a global tile's lanes
    (n_data * L of them, numpy or tensors); rank (d, s) renders block d at
    sample ``sample_lo + s`` into a fresh film, in one wavefront, which is
    then all-reduced over the mesh."""
    shard = _Shard(li_fn, camera, film, sampler, mesh, None)

    def step(ctx, px, py, valid, sample_lo: int = 0):
        fs = shard.render(ctx, film.init_state(shard.device), px, py, valid,
                          [sample_lo + shard.s])
        return film_all_reduce(fs)

    return step


def render_sharded(ctx, li_fn, camera, film, sampler, mesh,
                   max_lanes=1 << 16, progress=False,
                   sample_stop: Optional[int] = None):
    """The full sharded render -> (H, W, 3) image, the same on every rank.
    The global tile is ``min(max_lanes, n)`` lanes rounded up to a multiple
    of the data axis, the last one padded with invalid lanes; each tile
    renders samples [0, ``sample_stop`` or spp) in groups of the sample
    axis, rank (d, s) taking block d at sample s of each group. The film
    is linear in its samples, so each rank sums its tiles and groups into
    one film and the mesh all-reduces it once a render (the JAX package
    reduces once a step: only the order of float summation differs).
    ``progress`` prints a line a tile on rank 0."""
    n_data, n_sample = tuple(mesh.shape)
    stop = sampler.spp if sample_stop is None else sample_stop
    if sampler.spp % n_sample or stop % n_sample:
        raise ValueError(f"spp {sampler.spp} (rendered {stop}) must divide "
                         f"by sample axis {n_sample}")
    x0, y0, x1, y1 = film.get_sample_bounds()
    n = (x1 - x0) * (y1 - y0)
    tile = min(max_lanes, n)
    tile = -(-tile // n_data) * n_data
    px, py, valid = sample_lanes(film, tile)
    shard = _Shard(li_fn, camera, film, sampler, mesh, None)
    fs = film.init_state(shard.device)
    n_tiles = px.size // tile
    t0 = time.perf_counter()
    for ti in range(n_tiles):
        sl = slice(ti * tile, (ti + 1) * tile)
        fs = shard.render(ctx, fs, px[sl], py[sl], valid[sl],
                          range(shard.s, stop, n_sample))
        if progress and dist.get_rank() == 0:
            print(f"  shard-tile {ti + 1}/{n_tiles} elapsed "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    return film.to_image(film_all_reduce(fs))


def make_sharded_train_step(li_fn, camera, film, sampler, mesh, lr=0.1,
                            config: Optional[RenderConfig] = None):
    """-> train(ctx, target, px, py, valid, sample_lo=0) -> (new_ctx, loss
    (0-d tensor)), the same on every rank: one SGD step of ``mean((film's
    image - target)^2)`` over the float leaves of ``ctx.textures``, the
    film ``make_sharded_render_step``'s (lanes and samples as there; a
    rank's block in wavefronts of at most ``config.max_lanes``). The
    film's all-reduce passes its gradient through unchanged and the
    leaves' gradients are summed over the mesh, a leaf that no lane of a
    rank reached joining as zeros (of the last call, ``train.grads`` holds
    the summed gradients and ``train.unreached`` counts the leaves this
    rank did not reach).
    Refused as ``make_train_step`` for a Fourier BSDF (B11b); at world
    size 1 it equals ``make_train_step`` over the same lanes."""
    check_differentiable(li_fn)
    shard = _Shard(li_fn, camera, film, sampler, mesh, config)

    def train(ctx, target, px, py, valid, sample_lo: int = 0):
        leaves, rebuild = float_leaves(ctx.textures)
        theta = [p.detach().requires_grad_() for p in leaves]
        c = dataclasses.replace(ctx, textures=rebuild(theta))
        with torch.enable_grad():
            fs = film_all_reduce(shard.render(
                c, film.init_state(shard.device), px, py, valid,
                [sample_lo + shard.s]))
            loss = torch.mean((film.to_image(fs) - target) ** 2)
            # a rank that rendered no lane holds a constant film
            grads = torch.autograd.grad(loss, theta, allow_unused=True) \
                if loss.requires_grad else [None] * len(theta)
        train.unreached = sum(g is None for g in grads)
        grads = train.grads = all_reduce_grads(grads, theta)
        new = [(p - lr * g).detach() for p, g in zip(theta, grads)]
        return dataclasses.replace(ctx, textures=rebuild(new)), \
            loss.detach()

    train.unreached, train.grads = 0, []
    return train
