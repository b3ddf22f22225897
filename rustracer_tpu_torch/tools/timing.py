"""Device timings of one call on the card, shared by chip_smoke.py and the
kernel benchmarks of this package.

- ``events_ms``: CUDA events around a loop of calls.
- ``kernel_ms``: the device time of the kernels a call launches, by name,
  under torch.profiler: each name's mean duration over the launches the
  trace holds, summed over the names. A trace now and then comes back
  without some of the launches, so a sum over all of a trace's device
  events divided by the calls reads low. Where three traces in a row
  hold none of them, it raises ``NoDeviceRecords``. With ``per_call``,
  a call that launches one kernel several times, or several kernels
  under one name (a template's instantiations), is timed as the sum of
  its launches: each kernel's median times its launches a call, from a
  trace that holds every kernel the call launches.
- ``queued_ms``: the device time of a call with its launches queued ahead
  of the device (the host enqueues them behind a sleeping kernel), between
  CUDA events: the call's kernels and the device's gaps between dependent
  launches, not the host's issue time.
- ``cold_ms``: the time of a call that finds the L2 cache cold, as a
  render's one splat a step does: a buffer larger than the 50 MB L2 is
  written before every call, outside the timed span.
- ``device_ms``: ``kernel_ms`` (or ``cold_ms`` by name), or where the
  profiler lost every record, CUDA events around the call, and which of
  the two it took.

Each refuses to run without a CUDA device.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

L2_BYTES = 50 * 2 ** 20       # H100 SXM (NVIDIA data sheet)
FLUSH_BYTES = 128 * 2 ** 20   # written between cold calls: evicts all of L2
SLEEP_CYCLES = 50_000_000     # about 25 ms at 1.98 GHz


class NoDeviceRecords(AssertionError):
    """Three torch.profiler traces in a row held no device record of the
    named kernels."""


def _need_card():
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _span_us(e):
    return e.time_range.end - e.time_range.start


def events_ms(fn, reps):
    """Mean time of one call of ``fn``: CUDA events around ``reps`` calls,
    after a warm-up call (the host's issue time included where the calls
    are host-bound)."""
    _need_card()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def short_name(kernel):
    """A profiler kernel name without its return type, namespaces and
    arguments (a template's arguments kept)."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("::")[-1]


def kernel_ms(fn, reps, names, per_call=False, launches=None, medians=None):
    """Device time of the kernels of one call of ``fn`` whose names hold
    one of ``names`` (a string or a tuple): for each name, the mean
    duration of its launches in a trace of ``reps`` calls, summed over the
    names seen, after one warm-up call. A trace that holds none of them is
    taken again, at most three times in all.

    With ``per_call``, a call of several launches reads their sum: the
    warm-up call is traced too, for the kernels (full names) a call
    launches, and a trace is taken again unless it holds each of them at
    least ``reps`` / 2 times (the profiler now and then loses a kernel's
    records, all of them at times, which a sum would miss); each kernel
    counts its median
    launch times its launches a call (the trace's launches over ``reps``,
    rounded). ``launches``, a dict, then receives {full name: launches a
    call}, and ``medians`` {full name: its median ms}."""
    _need_card()
    names = (names,) if isinstance(names, str) else tuple(names)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def trace(calls):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans, kernels = {}, {}
        for e in _device_events(prof):
            if any(name in e.name for name in names):
                kernels.setdefault(e.name, []).append(_span_us(e))
            for name in names:
                if name in e.name:
                    spans.setdefault(name, []).append(_span_us(e))
        return spans, kernels

    if per_call:
        expected = set(trace(1)[1])
    else:
        fn()
        torch.cuda.synchronize()
    for _ in range(3):
        spans, kernels = trace(reps)
        if not spans:
            continue
        if not per_call:
            return sum(sum(v) / len(v) for v in spans.values()) * 1e-3
        expected |= set(kernels)
        if any(2 * len(kernels.get(k, ())) < reps for k in expected):
            continue
        counts = {k: round(len(v) / reps) for k, v in kernels.items()}
        med = {k: float(np.median(v)) * 1e-3 for k, v in kernels.items()}
        if launches is not None:
            launches.clear()
            launches.update(counts)
        if medians is not None:
            medians.clear()
            medians.update(med)
        return sum(med[k] * counts[k] for k in kernels)
    raise NoDeviceRecords(f"the profiler saw none of {names}" if not per_call
                          else f"no trace held every launch of {names}")


def queued_ms(fn, reps):
    """Mean device time of one call of ``fn`` with the host ahead of the
    device: a sleeping kernel holds the stream while the host enqueues
    ``reps`` calls between two CUDA events. Where the host took longer to
    enqueue them than the device slept, it sleeps 4x longer and times
    again, at most three times in all."""
    _need_card()
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise AssertionError(f"the host took {host_ms:.3f} ms to enqueue {reps} "
                         "calls, longer than the device slept")


def cold_ms(fn, reps=20, name=None, flush_bytes=FLUSH_BYTES):
    """Mean time of one call of ``fn`` that finds L2 cold: ``flush_bytes``
    (more than the L2) are written before each of ``reps`` calls, outside
    the timed span. With ``name``, the device time of the kernels whose
    name contains it (``kernel_ms``); without, CUDA events around
    each call, every call queued behind a sleeping kernel (the call's
    kernels and the device's gaps between them)."""
    if reps < 1:
        raise ValueError(f"reps must be at least 1, got {reps}")
    if flush_bytes <= L2_BYTES:
        raise ValueError(f"flush_bytes ({flush_bytes}) must exceed the "
                         f"{L2_BYTES}-byte L2")
    _need_card()
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    if name is not None:
        def flushed():
            flush.fill_(1)
            fn()
        return kernel_ms(flushed, reps, name)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (a, b) in enumerate(ev):
        flush.fill_(i)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def device_ms(fn, reps, names, cold=False, per_call=False, launches=None):
    """-> (ms, by): the device time of the kernels ``names`` in one call of
    ``fn``, by "profiler": ``kernel_ms``, or ``cold_ms`` by name where
    ``cold``. Where three traces in a row lose every record of them
    (``NoDeviceRecords``: torch.profiler now and then does), by "queued":
    CUDA events around the call (``queued_ms``, or ``cold_ms`` without a
    name where ``cold``), which also hold the call's other device work and
    the gaps between its launches; only after a call of ``fn`` is seen to
    launch a kernel of this package (rustracer_tpu_torch.cuda's counts),
    else it raises. ``per_call`` and ``launches`` as ``kernel_ms``'s
    (not with ``cold``)."""
    from .. import cuda
    try:
        if cold:
            return cold_ms(fn, reps, name=names), "profiler"
        return kernel_ms(fn, reps, names, per_call, launches), "profiler"
    except NoDeviceRecords as e:
        n0 = sum(cuda.LAUNCHES.values())
        fn()
        torch.cuda.synchronize()
        if sum(cuda.LAUNCHES.values()) == n0:
            raise AssertionError(f"{e}, and the call launches no kernel of "
                                 "this package") from e
        warnings.warn(f"{e} in 3 traces: timed with CUDA events around the "
                      "call", RuntimeWarning, stacklevel=2)
        return (cold_ms(fn, reps) if cold else queued_ms(fn, reps)), "queued"
