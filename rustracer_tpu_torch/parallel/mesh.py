"""Inverse rendering: the differentiable train step (port of
rustracer_tpu/parallel/mesh.py make_sharded_train_step, the one-device
case; the sharded form over torch.distributed is ROADMAP item A18).

The step renders one sample index over every pixel into the film, takes
``loss = mean((to_image(film) - target)^2)``, differentiates it with
respect to the float leaves of ``ctx.textures`` (the constant kd vectors
and every pyramid level; the int32 atlas metadata rides along) and applies
SGD. The gradient runs through the hand kernels' autograd Functions: K4's
backward K9, K5's K10, K8's K11, K17's K20 (the per-texture image
lookups) and K7 as its own transpose. A scene whose materials hold a
Fourier BSDF (K19, no backward yet: ROADMAP.md, section B, item B11b) is
refused when the step is built; a step whose gradient would run through a
sampled ray direction or a texture lookup's coordinates raises when it
gets there (item B12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
