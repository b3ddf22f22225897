"""Row-gather microbenchmark on one GPU: the plain ``table[idx]`` against
hand kernel K8 (the port of tools/bench_gather_pallas.py).

    python -m rustracer_tpu_torch.tools.bench_gather [log2_rows] [log2_batch]

Defaults: a 2^17 x 128 float32 table (64 MiB, BVH-record rows) and 2^20
random rows, both from numpy seed 0 as in the reference tool. Prints one
line for each route with ms, M rows/s, GB/s (rows x 512 bytes read plus the
same written) and the share of the H100's 3.35 TB/s; K8 must equal the
plain gather bit for bit (the rows may hold NaN bit patterns, as the BVH
records' packed integers do). Refuses to run without CUDA.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import cuda
from ..ops.gather import row_gather

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)


def _time_ms(fn, reps):
    """Least CUDA-event time of ``reps`` calls after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(table, idx, reps=5):
    """Time K8 and the plain gather on CUDA tensors and check they agree.
    -> dict(ms, plain_ms, rows_per_s, gb_per_s, plain_gb_per_s, equal)."""
    n = idx.shape[0]
    moved = 2.0 * n * table.shape[1] * 4      # bytes read + written
    out = row_gather(table, idx)
    with cuda.plain_reference():
        ref = row_gather(table, idx)
        plain_ms = _time_ms(lambda: row_gather(table, idx), reps)
    ms = _time_ms(lambda: row_gather(table, idx), reps)
    return dict(ms=ms, plain_ms=plain_ms, rows_per_s=n / (ms * 1e-3),
                plain_rows_per_s=n / (plain_ms * 1e-3),
                gb_per_s=moved / (ms * 1e-3) / 1e9,
                plain_gb_per_s=moved / (plain_ms * 1e-3) / 1e9,
                equal=bool(torch.equal(out.view(torch.int32),
                                       ref.view(torch.int32))))


def inputs(log2_rows=17, log2_batch=20, device="cuda"):
    """The reference tool's seed-0 table (R, 128) and indices (B,)."""
    rows, batch = 1 << log2_rows, 1 << log2_batch
    rs = np.random.RandomState(0)
    table = torch.as_tensor(rs.rand(rows, 128).astype(np.float32),
                            device=device)
    idx = torch.as_tensor(rs.randint(0, rows, batch).astype(np.int32),
                          device=device)
    return table, idx


def report(r, label=""):
    """Two lines (plain, K8) of a ``measure`` result."""
    lines = []
    for name, ms, rps, gbs in (
            ("plain table[idx]", r["plain_ms"], r["plain_rows_per_s"],
             r["plain_gb_per_s"]),
            ("K8 row_gather", r["ms"], r["rows_per_s"], r["gb_per_s"])):
        lines.append(f"{label}{name:18s}: {ms:8.4f} ms  {rps / 1e6:8.1f} M "
                     f"rows/s  {gbs:7.1f} GB/s  "
                     f"{100.0 * gbs * 1e9 / PEAK_BYTES_PER_S:5.1f}% of 3.35 "
                     "TB/s")
    lines[-1] += f"  equal={r['equal']}"
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather: no CUDA device; nothing runs on the "
                         "CPU")
    lr = int(argv[0]) if len(argv) > 0 else 17
    lb = int(argv[1]) if len(argv) > 1 else 20
    table, idx = inputs(lr, lb)
    print(f"table {table.shape[0]}x128 f32 "
          f"({table.shape[0] * 512 / 2**20:.0f} MiB), {idx.shape[0]} random "
          f"rows on {torch.cuda.get_device_name(0)}", file=sys.stderr)
    r = measure(table, idx)
    for line in report(r):
        print(line)
    if not r["equal"]:
        raise SystemExit("bench_gather: K8 differs from the plain gather")
    return r


if __name__ == "__main__":
    main()
