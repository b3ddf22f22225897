"""Host phase timers (port of rustracer_tpu/utils/stats.py: ``time_phase``
and ``print_phases``). The reference's counters and the device counts it
observes are not ported (ROADMAP.md, section A, item 17)."""
from __future__ import annotations

import sys
import time
from typing import Dict

_phases: Dict[str, float] = {}   # wall seconds per phase name


def init_stats():
    """Reset the phase timings."""
    _phases.clear()


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
