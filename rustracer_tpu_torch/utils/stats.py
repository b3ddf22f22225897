"""Counters and phase timers (port of rustracer_tpu/utils/stats.py), in the
reference's categorised "Category/Title" report (stats/mod.rs:83-201):
counters, memory counters, integer distributions, percents, ratios, and the
per-phase wall times.

Counts the device observes during a render (the renderer's per-step
counters, the integrator's intersection tests, the texture lookups) go on
a device tape: ``device_count`` adds a host int or a device scalar under a
name while a tape is open, and nothing when none is (a test, a train step).
The renderer opens the tape for one ``render_state`` and closes each step
with ``DeviceTape.end_step``, which folds the step's device scalars into
one int64 vector on the device (two launches a step); ``DeviceTape.fetch``
brings the sums, minima and maxima to the host with one sync at the end.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

_counters: Dict[str, int] = {}
_memory: Dict[str, int] = {}
_distributions: Dict[str, Tuple[int, int, int, int]] = {}  # sum, n, lo, hi
_percents: Dict[str, Tuple[int, int]] = {}
_ratios: Dict[str, Tuple[int, int]] = {}
_phases: Dict[str, float] = {}   # wall seconds per phase name


def init_stats():
    """Reset every registry (the reference's init_stats, lib.rs)."""
    for reg in (_counters, _memory, _distributions, _percents, _ratios,
                _phases):
        reg.clear()


class time_phase:
    """Context manager adding its wall time to a phase name."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _phases[self.name] = _phases.get(self.name, 0.0) + \
            time.perf_counter() - self._t0
        return False


def phases() -> Dict[str, float]:
    """The phase timings so far, name -> seconds."""
    return dict(_phases)


def print_phases(file=None):
    file = file or sys.stdout
    if not _phases:
        return
    print("Phase timings:", file=file)
    for name, secs in sorted(_phases.items(), key=lambda kv: -kv[1]):
        print(f"    {name:<42}{secs:9.3f} s", file=file)


def counter_add(name: str, n: int = 1):
    _counters[name] = _counters.get(name, 0) + int(n)


def memory_add(name: str, nbytes: int):
    _memory[name] = _memory.get(name, 0) + int(nbytes)


def distribution_report(name: str, value: int, count: int = 1):
    s, c, lo, hi = _distributions.get(name, (0, 0, 1 << 62, -(1 << 62)))
    _distributions[name] = (s + int(value), c + count,
                            min(lo, int(value)), max(hi, int(value)))


def percent_report(name: str, num: int, denom: int):
    n, d = _percents.get(name, (0, 0))
    _percents[name] = (n + int(num), d + int(denom))


def ratio_report(name: str, num: int, denom: int):
    n, d = _ratios.get(name, (0, 0))
    _ratios[name] = (n + int(num), d + int(denom))


class DeviceTape:
    """Sums (of host ints or 0-d device tensors), minima and maxima (of
    0-d device tensors) by name. Host ints are summed on the host. A
    step's tensors wait in a list until ``end_step``, which stacks each
    kind into one vector and folds it into that kind's accumulator for
    the step's sequence of names (the same every step of a render)."""

    _FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}

    def __init__(self):
        self.host = {}
        self._step = {kind: [] for kind in self._FOLD}
        self._acc = {}   # (kind, names) -> int64 vector

    def add(self, name, value):
        if isinstance(value, torch.Tensor):
            self._step["sum"].append((name, value))
        else:
            self.host[name] = self.host.get(name, 0) + int(value)

    def min(self, name, value):
        self._step["min"].append((name, value))

    def max(self, name, value):
        self._step["max"].append((name, value))

    def end_step(self):
        """Fold the step's device scalars into the accumulators."""
        for kind, vals in self._step.items():
            if not vals:
                continue
            key = (kind, tuple(n for n, _ in vals))
            vec = torch.stack([v for _, v in vals]).long()
            acc = self._acc.get(key)
            self._acc[key] = vec if acc is None else \
                self._FOLD[kind](acc, vec, out=acc)
            vals.clear()

    def fetch(self):
        """-> (sums, mins, maxs) as dicts of Python ints: the device
        values in one transfer."""
        self.end_step()
        keys = list(self._acc)
        flat = torch.cat([self._acc[k] for k in keys]).tolist() \
            if keys else []
        out = {"sum": dict(self.host), "min": {}, "max": {}}
        pick = {"sum": lambda a, b: a + b, "min": min, "max": max}
        i = 0
        for kind, names in keys:
            reg = out[kind]
            for n in names:
                reg[n] = flat[i] if n not in reg else pick[kind](reg[n],
                                                                 flat[i])
                i += 1
        return out["sum"], out["min"], out["max"]


_tape: Optional[DeviceTape] = None


def device_tape_begin() -> DeviceTape:
    global _tape
    _tape = DeviceTape()
    return _tape


def device_tape_end() -> Optional[DeviceTape]:
    global _tape
    tape, _tape = _tape, None
    return tape


def counting() -> bool:
    """True while a device tape is open: only then is a count worth
    computing."""
    return _tape is not None


def device_count(name: str, value):
    """Add ``value`` (a host int or a device scalar) to the open tape."""
    if _tape is not None:
        _tape.add(name, value)


def _split(name):
    if "/" in name:
        cat, title = name.split("/", 1)
    else:
        cat, title = "Misc", name
    return cat, title


def _fmt_mem(nbytes):
    kb = nbytes / 1024.0
    if kb < 1024:
        return f"{kb:9.2f} kB"
    mib = kb / 1024.0
    if mib < 1024:
        return f"{mib:9.2f} MiB"
    return f"{mib / 1024.0:9.2f} GiB"


def print_stats(file=None):
    """The categorised table (stats/mod.rs:83-201 format)."""
    file = file or sys.stdout
    by_cat = defaultdict(list)
    for name, v in _counters.items():
        if v:
            by_cat[_split(name)[0]].append((_split(name)[1], f"{v:12d}"))
    for name, v in _memory.items():
        if v:
            by_cat[_split(name)[0]].append((_split(name)[1], _fmt_mem(v)))
    for name, (s, c, lo, hi) in _distributions.items():
        if c:
            by_cat[_split(name)[0]].append(
                (_split(name)[1], f"{s / c:.3f} avg [range {lo} - {hi}]"))
    for name, (n, d) in _percents.items():
        if d:
            by_cat[_split(name)[0]].append(
                (_split(name)[1], f"{100.0 * n / d:.2f}% ({n}/{d})"))
    for name, (n, d) in _ratios.items():
        if d:
            by_cat[_split(name)[0]].append(
                (_split(name)[1], f"{n / d:.2f}x ({n}/{d})"))
    print("Statistics:", file=file)
    for cat in sorted(by_cat):
        print(f"  {cat}", file=file)
        for title, val in sorted(by_cat[cat]):
            print(f"    {title:<42}{val}", file=file)
