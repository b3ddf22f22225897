"""What each rank runs under ``launch.spawn``: sharded renders and train
steps of a scene every rank builds for itself (a builder of scenes.py and
its keyword arguments), their results returned on the host.

A task is a dict: ``build`` (e.g. ``scenes.build_cornell``, called with
``device=`` and ``kw``; the first five of what it returns are the
context, camera, film, sampler and integrator), ``renders`` (a list of
dicts: ``shape`` (data, sample), ``max_lanes`` and optionally
``sample_stop`` and ``warm``, a first render of one sample group) and
``train`` (a dict: ``shape``, ``target`` (H, W, 3), ``lr``, optionally
``max_lanes`` (a rank's wavefront) and ``lanes`` (px, py, valid; default
the film's sample bounds padded to the data axis); sample 0 and up), and
``reduce_numel`` (sizes of float32 buffers whose all-reduce is timed).
"""
from __future__ import annotations

import time

import torch

from .. import cuda as K
from ..render.renderer import RenderConfig
from .launch import all_reduce_ms
from .mesh import (float_leaves, make_device_mesh, make_sharded_train_step,
                   render_sharded, sample_lanes)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _render(ctx, cam, film, sampler, integ, device, r):
    mesh = make_device_mesh(*r["shape"], device=device)
    stop = r.get("sample_stop")
    if r.get("warm"):
        render_sharded(ctx, integ.li, cam, film, sampler, mesh,
                       r["max_lanes"], sample_stop=mesh.shape[1])
    _sync(device)
    K.reset_launches()
    t0 = time.perf_counter()
    img = render_sharded(ctx, integ.li, cam, film, sampler, mesh,
                         r["max_lanes"], sample_stop=stop)
    _sync(device)
    return dict(image=img.cpu(), seconds=time.perf_counter() - t0,
                launches=dict(K.LAUNCHES))


def _train(ctx, cam, film, sampler, integ, device, t):
    mesh = make_device_mesh(*t["shape"], device=device)
    config = RenderConfig(max_lanes=t["max_lanes"]) \
        if t.get("max_lanes") else None
    step = make_sharded_train_step(integ.li, cam, film, sampler, mesh,
                                   lr=t["lr"], config=config)
    px, py, valid = t.get("lanes") or sample_lanes(film, mesh.shape[0])
    target = torch.as_tensor(t["target"], device=device)
    _sync(device)
    K.reset_launches()
    t0 = time.perf_counter()
    new, loss = step(ctx, target, px, py, valid)
    _sync(device)
    return dict(loss=float(loss), seconds=time.perf_counter() - t0,
                launches=dict(K.LAUNCHES), unreached=step.unreached,
                leaves=[p.cpu() for p in float_leaves(new.textures)[0]],
                grads=[g.cpu() for g in step.grads])


def mesh_job(rank, world_size, device, tasks):
    """Each task of ``tasks`` on this rank -> a list of dicts, one a task:
    ``renders`` (image, seconds, launches: the port's kernels counted from
    0 just before each render), ``train`` (loss, new float leaves, the
    summed gradients, unreached, seconds, launches), ``reduce_ms`` and,
    on the card, ``peak_bytes`` (torch.cuda.max_memory_allocated over the
    task)."""
    out = []
    for task in tasks:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ctx, cam, film, sampler, integ = task["build"](
            device=device, **task.get("kw", {}))[:5]
        res = dict(renders=[_render(ctx, cam, film, sampler, integ, device,
                                    r) for r in task.get("renders", ())])
        if task.get("train"):
            res["train"] = _train(ctx, cam, film, sampler, integ, device,
                                  task["train"])
        res["reduce_ms"] = [all_reduce_ms(n, device)
                            for n in task.get("reduce_numel", ())]
        if device.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out.append(res)
    return out
