"""Ranks of one host as processes: join the default process group, spawn
a job on every rank and collect what each returns.

The backend follows the device: NCCL for ``device="cuda"``, one rank a
card (``cuda:rank``, set before the group is made); gloo for ``"cpu"``.
gloo on the card only where the caller names it (``backend="gloo"``), for
several ranks on one card (``cuda:rank % cards``): NCCL refuses two ranks
on one device. Nothing falls back from NCCL to gloo or from the card to
the CPU. Every collective runs on the default group, whose ``timeout``
(seconds) ends a rank that waits on a peer that failed.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist


def init_rank(rank: int, world_size: int, init_method: str, device="cuda",
              backend=None, timeout: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (e.g. ``file:///tmp/x/rendezvous`` or
    ``tcp://localhost:<port>``) -> the device this rank renders on."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend} on the CPU: the CPU takes gloo")
    kw = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_rank: no CUDA device; ask for "
                               "device='cpu'")
        cards = torch.cuda.device_count()
        if backend == "nccl" and world_size > cards:
            raise ValueError(
                f"NCCL takes one rank a card: {world_size} ranks, {cards} "
                "cards; name backend='gloo' for several ranks on one card")
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dev


def prebuild(device="cuda"):
    """Build what every rank would otherwise build at once: the native BVH
    builder and, for the card, the kernel library (rank processes load the
    cached builds)."""
    from ..accel import bvh_build
    bvh_build._native()
    if torch.device(device).type == "cuda":
        from .. import cuda
        cuda.library_path()


def _rank_main(rank, world_size, tmp, job, args, device, backend, timeout):
    torch.set_num_threads(1)
    dev = init_rank(rank, world_size, f"file://{tmp}/rendezvous", device,
                    backend, timeout)
    out = job(rank, world_size, dev, *args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn(job, nprocs: int, *args, device="cuda", backend=None,
          timeout: float = 600.0):
    """Run ``job(rank, world_size, device, *args)`` on ``nprocs`` ranks,
    each a process of its own with one CPU thread
    (``torch.multiprocessing.spawn``) joined through a ``file://``
    rendezvous in a temporary directory -> the jobs' return values (host
    data, pickled), by rank. ``job`` lives in an
    importable module, not in ``__main__``. A rank that raises stops the
    others, and the error is raised here."""
    import torch.multiprocessing as mp
    prebuild(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(nprocs, tmp, job, args, device, backend,
                                   timeout),
                 nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]


def all_reduce_ms(numel: int, device, reps: int = 10) -> float:
    """Milliseconds of one SUM all-reduce of ``numel`` float32 on
    ``device`` over the default group, the mean of ``reps`` after one
    warm-up (CUDA events on the card, the host clock on the CPU)."""
    buf = torch.ones(numel, dtype=torch.float32, device=device)
    dist.all_reduce(buf)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dist.all_reduce(buf)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf)
    return (time.perf_counter() - t0) * 1e3 / reps
