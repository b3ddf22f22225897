"""The measurement helpers of K4, K5 and K6 on the CPU: K5's work count
(tools/atlas_work.py) against a count by hand on a tiny atlas, the cold
timer's argument handling (tools/timing.py), and the recording of one
render step's K5, K6 and K8 inputs (tools/bench_step_kernels.py)."""
from types import SimpleNamespace

import pytest
import torch

from rustracer_tpu_torch.integrators import path as P
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.ops.mipmap import (WRAP_BLACK, WRAP_CLAMP,
                                            WRAP_REPEAT, build_pyramid)
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scene import atlas as A
from rustracer_tpu_torch.scene import materials as M
from rustracer_tpu_torch.scenes import build_dragon
from rustracer_tpu_torch.tools import atlas_work as W
from rustracer_tpu_torch.tools import timing
from rustracer_tpu_torch.tools.bench_step_kernels import capture_step

torch.set_num_threads(1)


def _tiny(wrap):
    """One 4x4 image (levels at texel offsets 0, 16 and 20), one
    registration with the identity mapping, and three lanes with zero
    differentials (so level 0 and 1 at one st for every tap): lane 0
    untextured, lane 1 at uv (0.5, 0.5), lane 2 at (0.1, 0.1)."""
    img = torch.arange(48, dtype=torch.float32).reshape(4, 4, 3).numpy()
    meta = A.build_atlas_meta([build_pyramid(img)])
    tex = SimpleNamespace(image_id=0, wrap=wrap, scale=1.0,
                          mapping=SimpleNamespace(su=1.0, sv=1.0, du=0.0,
                                                  dv=0.0))
    regs = A.registrations_on(A.build_registrations([tex]), "cpu")
    zero = torch.zeros(3)
    si = SimpleNamespace(uv=torch.tensor([[0.3, 0.3], [0.5, 0.5],
                                          [0.1, 0.1]]),
                         dudx=zero, dvdx=zero, dudy=zero, dvdy=zero)
    return (torch.as_tensor(meta["atlas_meta"]),
            torch.as_tensor(meta["atlas_levels"]), regs,
            torch.tensor([-1, 0, 0], dtype=torch.int32), si)


# by hand: lane 1 reads level 0 at (s0, t0) = (1, 1) and level 1 at (0, 0);
# lane 2 at (-1, -1) on both, which REPEAT wraps to (3, 3) and (1, 1)
@pytest.mark.parametrize("quad,wrap,rows", [
    # quad rows t0 * w + s0 + offset: 5 and 16 + 0; 15 and 16 + 3
    (True, WRAP_REPEAT, [5, 15, 16, 19]),
    # the 2x2 texels of each: 5 6 9 10, 16-19; 15 12 3 0, 19 18 17 16
    (False, WRAP_REPEAT, [0, 3, 5, 6, 9, 10, 12, 15, 16, 17, 18, 19]),
    # lane 2 reads only texel (0, 0) of each level
    (False, WRAP_BLACK, [0, 5, 6, 9, 10, 16, 17, 18, 19]),
    # ... and clamps its other three to it
    (False, WRAP_CLAMP, [0, 5, 6, 9, 10, 16, 17, 18, 19]),
])
def test_k5_work_counts_by_hand(quad, wrap, rows):
    meta, levels, regs, reg, si = _tiny(wrap)
    assert W.k5_rows(meta, levels, regs, reg, si, quad).tolist() == rows
    work = W.k5_work(meta, levels, regs, reg, si, quad)
    row_bytes = 48 if quad else 12
    assert work == dict(lanes=3, textured=2, rows=len(rows),
                        bytes=3 * 16 + 2 * 24 + len(rows) * row_bytes,
                        ops=2 * 450)
    # a few hundred bytes take longer than 900 operations
    assert W.k5_bound(work) == (work["bytes"] / W.PEAK_BYTES_PER_S * 1e3,
                                "bytes")
    many = dict(work, lanes=3 << 20, textured=1 << 20, ops=450 << 20)
    assert W.k5_bound(many) == ((450 << 20) / W.PEAK_OPS_PER_S * 1e3,
                                "operations")


def test_k5_work_without_textured_lanes():
    meta, levels, regs, reg, si = _tiny(WRAP_REPEAT)
    work = W.k5_work(meta, levels, regs, torch.full_like(reg, -1), si, True)
    assert work == dict(lanes=3, textured=0, rows=0, bytes=48, ops=0)
    assert W.k5_bound(work) == (48 / W.PEAK_BYTES_PER_S * 1e3, "bytes")


def test_cold_ms_argument_handling():
    with pytest.raises(ValueError, match="reps"):
        timing.cold_ms(lambda: None, reps=0)
    with pytest.raises(ValueError, match="L2"):
        timing.cold_ms(lambda: None, flush_bytes=timing.L2_BYTES)
    assert timing.FLUSH_BYTES > timing.L2_BYTES
    if not torch.cuda.is_available():
        for fn in (lambda: timing.cold_ms(lambda: None),
                   lambda: timing.queued_ms(lambda: None, 1),
                   lambda: timing.kernel_ms(lambda: None, 1, "k")):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()


def test_capture_step_records_the_step(monkeypatch):
    """A 32^2 textured dragon in one 1024-lane tile, with the slab tiers
    opened to it: the step makes 4 K5 calls (bounce 0 and 3 interior
    bounces, one atlas slot), 1 K6 call and 4 material-row gathers, and
    recording them leaves the step's result unchanged."""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 256)
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=3, res=(32, 32),
                                                     device="cpu")
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=1024),
                 device="cpu")
    px, py, v = tile = r.tiles[0]
    recorded = (A.atlas_lookup_ewa, C.alive_first_order, M.row_gather)
    before = r.step(ctx, film.init_state("cpu"), px, py, 1, v).rgb
    cap = capture_step(r, ctx, tile)
    assert (A.atlas_lookup_ewa, C.alive_first_order, M.row_gather) \
        == recorded
    assert torch.equal(r.step(ctx, film.init_state("cpu"), px, py, 1,
                              v).rgb, before)
    assert [len(cap[k]) for k in ("k5", "k6", "k8")] == [4, 1, 4]
    assert cap["k6"][0].dtype == torch.bool
    assert cap["k6"][0].shape == (1024,)
    first = cap["k5"][0]
    assert first["quad"] and first["reg"].shape == (1024,)
    assert 0 < int((first["reg"] >= 0).sum()) < 1024
    for c in cap["k5"]:
        work = W.k5_work(c["meta"], c["levels"], c["regs"], c["reg"],
                         c["si"], c["quad"])
        assert work["ops"] == 450 * int((c["reg"] >= 0).sum())
        assert work["rows"] <= 16 * work["textured"]
    table, idx = cap["k8"][0]
    assert table.shape[1] == 16 and idx.shape == (1024,)
