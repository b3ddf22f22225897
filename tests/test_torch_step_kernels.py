"""The measurement helpers of K4-K7 on the CPU: K5's work count
(tools/atlas_work.py) and K4's and K7's byte counts
(tools/bench_step_kernels.py) against counts by hand, the cold timer's
argument handling (tools/timing.py), and the recording of one render
step's K4-K8 inputs (tools/bench_step_kernels.py)."""
from types import SimpleNamespace

import pytest
import torch

from rustracer_tpu_torch.integrators import path as P
from rustracer_tpu_torch.ops import compact as C
from rustracer_tpu_torch.ops.mipmap import (WRAP_BLACK, WRAP_CLAMP,
                                            WRAP_REPEAT, build_pyramid)
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.filters import Filter
from rustracer_tpu_torch.render.renderer import RenderConfig, Renderer
from rustracer_tpu_torch.scene import atlas as A
from rustracer_tpu_torch.scene import materials as M
from rustracer_tpu_torch.scenes import build_dragon
from rustracer_tpu_torch.tools import atlas_work as W
from rustracer_tpu_torch.tools import timing
from rustracer_tpu_torch.tools import bench_step_kernels as B
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


# K10 on the same lanes, by hand: lane 1's 64 adds go to level 0's quad at
# (1, 1) (texels 5 6 9 10, weights 1/4 each) and level 1's at (0, 0) (16-19);
# lane 2's to level 0's quad at (-1, -1) and level 1's at (-1, -1), which
# REPEAT wraps to texels 15 12 3 0 and 19 18 17 16, CLAMP clamps onto 0 and
# 16, and BLACK keeps one corner of (0 and 16). The parent adds each of a
# lane's 64 adds apart, but where the two lanes meet on a texel at one add
# number (CLAMP: texel 16 at level 1's corner 0, on 8 taps: 120 adds of
# 128); K10 runs each lookup on 8 threads (one tap each), skips level 1
# (blend 0), and sums a corner over the 8 taps: 4 texels for lane 1, 4 for
# lane 2 (1 once clamped or black), 3 channels each. The busiest texel: 16
# and up, 8 adds from each lane (REPEAT), or 32 from lane 2 and 8 from
# lane 1 (CLAMP)
@pytest.mark.parametrize("quad,wrap,adds,parent,new,most", [
    (True, WRAP_REPEAT, 128, 384, 24, 16),
    (False, WRAP_REPEAT, 128, 384, 24, 16),
    (False, WRAP_BLACK, 80, 240, 15, 16),
    (False, WRAP_CLAMP, 128, 360, 15, 40),
])
def test_k10_work_and_atomics_by_hand(quad, wrap, adds, parent, new, most):
    meta, levels, regs, reg, si = _tiny(wrap)
    n_texels = 21
    work = W.k10_work(meta, levels, regs, reg, si, n_texels)
    assert work == dict(lanes=3, textured=2,
                        bytes=3 * 4 + 2 * (24 + 12) + n_texels * 12,
                        ops=2 * W.K10_LANE_OPS)
    g = torch.tensor([[1.0, 2.0, 3.0]] * 3)
    assert W.k10_atomics(meta, levels, regs, reg, si, quad, g,
                         n_texels) == dict(adds=adds, parent=parent, new=new,
                                           max_adds_texel=most)
    # no textured lane: nothing to add
    none = torch.full_like(reg, -1)
    assert W.k10_atomics(meta, levels, regs, none, si, quad, g, n_texels) \
        == dict(adds=0, parent=0, new=0, max_adds_texel=0)


# a 4 x 3 film; by hand, with box 0.5 each sample's one tap: (0.5, 0.5)
# and (0.25, 0.5) on pixel (0, 0), (3.75, 2.5) on (3, 2), (1.0, 1.5) (on a
# pixel edge) on (0, 1), (-3, -3) off the film, (2.5, 0.5) on (2, 0);
# with box 1.5 (3 x 3 taps from ceil(p - 2)): the first two on x, y in
# {0, 1}, the third on x {2, 3} x y {1, 2}, the fourth on x {0, 1} x y
# {0, 1, 2}, the fifth off the film, the sixth on x {1, 2, 3} x y {0, 1}
K4_SAMPLES = [[0.5, 0.5], [0.25, 0.5], [3.75, 2.5], [1.0, 1.5], [-3.0, -3.0],
              [2.5, 0.5]]


@pytest.mark.parametrize("width,masked,touched", [
    (0.5, True, 3), (0.5, False, 4),
    (1.5, True, 10), (1.5, False, 12),   # the sixth adds (2, 0) and (3, 0)
])
def test_k4_bytes_by_hand(width, masked, touched):
    film = Film(full_resolution=(4, 3), filter=Filter("box", width, width))
    p_film = torch.tensor(K4_SAMPLES)
    rad = torch.ones(6, 3)
    valid = torch.tensor([True] * 5 + [False]) if masked else None
    assert B.k4_touched(film, p_film, valid) == touched
    # 8 + 12 (+ 1) bytes a sample in, 16 bytes a touched pixel read and
    # written
    assert B.k4_moved(film, p_film, rad, valid) \
        == 6 * (20 + masked) + 32 * touched
    # the plain splat's nonzero weights land on exactly those pixels
    st = film.add_samples(film.init_state("cpu"), p_film, rad, valid)
    assert int((st.wsum > 0).sum()) == touched


@pytest.mark.parametrize("kind,radius,ops", [
    # 4 + 4 axis weights of 7, 16 taps of 6
    ("triangle", 2.0, 8 * 7 + 16 * 6),
    ("gaussian", 2.0, 8 * 10 + 16 * 6),
    ("mitchell", 2.0, 8 * 26 + 16 * 6),
    # 3 + 3 weights, 9 taps
    ("mitchell", 1.5, 6 * 26 + 9 * 6),
])
def test_k4_operations_by_hand(kind, radius, ops):
    film = Film(full_resolution=(8, 8),
                filter=Filter(kind, radius, radius))
    assert B.k4_ops(film, 5) == 5 * ops


# K9 with a radius-2 filter on the same samples (footprints of 4 x 4 from
# ceil(p - 2.5)), by hand: the triangle and the Gaussian weigh |d| < 2
# above 0, so the first two samples land on x, y in {0, 1}, the third on
# x {2, 3} x y {1, 2}, the fourth on x {0, 1, 2} x y {0, 1, 2} and the
# sixth on x {1, 2, 3} x y {0, 1}. Mitchell (B = C = 1/3) is above 0 for
# |d| < 8/7 and below it for 8/7 < |d| < 2, where a tap lands only if both
# axes are below 0, and its float32 weight at |d| = 2 is a rounding's
# width above 0: the first sample lands on x, y in {0, 1}, the second on
# x 0 x y {0, 1}, the third on x 3 x y {0, 1, 2}, the fourth on x {0, 1} x
# y {0, 1, 2}, the sixth on x {0, 1, 2, 3} x y {0, 1} (x 0 at |d| = 2, x 1
# and 3 at |d| = 1). At radius 1.5 (3 x 3 taps from ceil(p - 2)) it is
# above 0 for |d| < 6/7 and below it for 6/7 < |d| < 1.5: the first two
# samples land on (0, 0) and (1, 1), the third on (2, 1) and (3, 2), the
# fourth on (0, 1) and (1, 1), the sixth on (2, 0), (1, 1) and (3, 1)
K9_TOUCHED = {("triangle", 2.0): (11, 12), ("gaussian", 2.0): (11, 12),
              ("mitchell", 2.0): (9, 11), ("mitchell", 1.5): (5, 7)}


@pytest.mark.parametrize("kind,radius", sorted(K9_TOUCHED))
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("clamp", [False, True])
def test_k9_bytes_by_hand(kind, radius, masked, clamp):
    film = Film(full_resolution=(4, 3), filter=Filter(kind, radius, radius),
                max_sample_luminance=2.0 if clamp else float("inf"))
    p_film = torch.tensor(K4_SAMPLES)
    rad = torch.ones(6, 3)
    valid = torch.tensor([True] * 5 + [False]) if masked else None
    touched = K9_TOUCHED[(kind, radius)][0 if masked else 1]
    assert B.k4_touched(film, p_film, valid) == touched
    # 8 bytes of position (+ 1 of valid, + 12 of radiance with the clamp)
    # a sample in, 12 of gradient out, 16 bytes a touched pixel read
    assert B.k9_moved(film, p_film, rad, valid) \
        == 6 * (20 + masked + 12 * clamp) + 16 * touched
    # the plain splat's nonzero weights land on exactly those pixels
    st = film.add_samples(film.init_state("cpu"), p_film, rad, valid)
    assert int((st.wsum > 0).sum()) == touched


@pytest.mark.parametrize("kind,radius,ops", [
    # 4 + 4 axis weights, 16 taps of 8
    ("triangle", 2.0, 8 * 7 + 16 * 8),
    ("gaussian", 2.0, 8 * 10 + 16 * 8),
    ("mitchell", 2.0, 8 * 26 + 16 * 8),
    # 3 + 3 weights, 9 taps
    ("mitchell", 1.5, 6 * 26 + 9 * 8),
])
@pytest.mark.parametrize("clamp", [False, True])
def test_k9_operations_by_hand(kind, radius, ops, clamp):
    film = Film(full_resolution=(8, 8), filter=Filter(kind, radius, radius),
                max_sample_luminance=2.0 if clamp else float("inf"))
    # the clamp's VJP: 31 operations a sample
    assert B.k9_ops(film, 5) == 5 * (ops + 31 * clamp)


def test_k9_parts_replace_one_tap(tmp_path):
    """tools/k9_parts.py finds the staged kernel's tap in csrc/film_bwd.cu
    once and writes each diagnostic build beside its headers, the source
    changed only there."""
    from rustracer_tpu_torch._build import CSRC
    from rustracer_tpu_torch.tools import k9_parts
    with open(f"{CSRC}/film_bwd.cu") as f:
        source = f.read()
    paths = k9_parts.write_parts(str(tmp_path))
    assert sorted(paths) == sorted(k9_parts.PARTS)
    for part, path in paths.items():
        old, new = k9_parts.PARTS[part]
        with open(path) as f:
            text = f.read()
        assert text == source.replace(old, new) and text != source
        assert (tmp_path / part / "filter.cuh").exists()
    with pytest.raises(ValueError, match="once"):
        k9_parts.part_source("no kernel here", "loads")


def test_filtered_splat_cases():
    """K4F's inputs: ``with_filter`` swaps the film's filter for PBRT's
    default (radius 2) and keeps the samples; ``permuted`` reorders the
    samples, which leaves the plain splat within float rounding."""
    film = Film(full_resolution=(16, 8), filter=Filter("box", 0.5, 0.5))
    gen = torch.Generator()
    gen.manual_seed(3)
    p_film = torch.rand((300, 2), generator=gen) * torch.tensor([16.0, 8.0])
    case = dict(film=film, p_film=p_film,
                radiance=torch.rand((300, 3), generator=gen),
                valid=torch.rand(300, generator=gen) > 0.2)
    for kind in B.FILTERS:
        f = B.with_filter(case, kind)
        assert f["film"].filter.kind == kind
        assert f["film"].filter.radius == (2.0, 2.0)
        assert f["p_film"] is case["p_film"]
        sums = []
        for c in (f, B.permuted(f, seed=1)):
            call, get = B.k4_call(None, c)
            call()
            sums.append(get())
        assert not torch.equal(B.permuted(f, seed=1)["p_film"], p_film)
        torch.testing.assert_close(sums[0], sums[1], rtol=1e-5, atol=1e-6)
        assert float(sums[0][..., 3].sum()) > 0


def test_k12_call_is_the_whole_grid():
    """K12's benchmark call on the CPU: the library's route (the plain
    version, chunked) over a small grid equals the sums over its corners
    in one chunk."""
    from rustracer_tpu_torch.scene import lightdistrib as LD
    ctx = build_dragon(sub=1, res=(8, 8), device="cpu")[0]
    lo = ctx.geom.tv_p.min(0).values.numpy()
    hi = ctx.geom.tv_p.max(0).values.numpy()
    nv, _, ext = LD.voxels(lo, hi, 6)
    halton = torch.as_tensor(LD._radical_inverse_table(16))
    out = B.k12_call(None, ctx.lights, lo, ext, nv, halton)
    v = int(nv.prod())
    ref = LD.grid_contrib_plain(ctx.lights, LD.voxel_corners(lo, ext, nv, 0,
                                                             v), ext, halton)
    assert out.shape == (v, ctx.lights.n_lights)
    assert torch.equal(out, ref)
    assert float(ref.max()) > 0


def test_k7_bytes_by_hand():
    n, w = 5, 2
    fields = [torch.zeros(n, 3), torch.zeros(n), torch.zeros(n, dtype=bool),
              torch.zeros(n, dtype=torch.int64)]
    # 4 bytes of order a slab lane; 12 + 4 + 1 + 8 bytes a lane read and
    # written
    assert B.k7_moved(fields, w) == w * (4 + 2 * 25)
    assert B.k7_moved(fields, 0) == 0


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


def test_device_ms_needs_a_card():
    """device_ms refuses to time without a CUDA device, as kernel_ms does,
    and a lost trace is an AssertionError of its own."""
    assert issubclass(timing.NoDeviceRecords, AssertionError)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            timing.device_ms(lambda: None, 1, "k")


def test_capture_step_records_the_step(monkeypatch):
    """A 32^2 textured dragon in one 1024-lane tile, with the slab tiers
    opened to it: the step makes 1 splat, 4 K5 calls (bounce 0 and 3
    interior bounces, one atlas slot), 1 K6 call and 4 material-row
    gathers, and recording them leaves the step's result unchanged."""
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
    assert [len(cap[k]) for k in ("k4", "k5", "k6", "k8")] == [1, 4, 1, 4]
    k4 = cap["k4"][0]
    assert k4["film"] is film and k4["p_film"].shape == (1024, 2)
    assert k4["radiance"].shape == (1024, 3) and k4["valid"].all()
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


def test_filtered_grad_step_records_k9(monkeypatch):
    """The backward of one step of a 32^2 textured dragon (1024-lane
    tiles, the slab tiers opened to them) rendered with the Mitchell
    filter makes one K9 call, on a film whose filter is PBRT's Mitchell
    at radius 2 (the renderer's own film keeps its box), with the film
    buffer's (H, W, 4) gradient and the samples of that film's renderer's
    first tile; the plain gather on it is finite and not all zero."""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 256)
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=3, res=(32, 32),
                                                     device="cpu")
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=1024),
                 device="cpu")
    seen, capture = [], B.capture_grad_step
    monkeypatch.setattr(B, "capture_grad_step", lambda *a, **kw:
                        seen.append(capture(*a, **kw)) or seen[-1])
    case = B.filtered_grad_step(r, ctx, 0, kind="mitchell")
    assert len(seen) == 1 and len(seen[0]["k9"]) == 1
    assert case is seen[0]["k9"][0]
    (f, g_acc, p_film, rad, valid), _ = case
    assert f.filter == Filter("mitchell", 2.0, 2.0)
    assert film.filter.kind == "box" and r.film is film
    assert g_acc.shape == (32, 32, 4) and p_film.shape == (1024, 2)
    assert rad.shape == (1024, 3) and bool(valid.all())
    # the tile of the filtered film's renderer: row-major over its sample
    # bounds, 36 x 36 pixels from (-2, -2)
    i = torch.arange(1024)
    assert torch.equal(torch.floor(p_film).long(),
                       torch.stack([i % 36 - 2, i // 36 - 2], -1))
    g = B.k9_call(None, case)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_capture_step_records_the_slab(monkeypatch):
    """The top 256-lane tile of a 32^2 textured dragon, mostly sky, takes
    the B/4 slab: K7's fields are recorded as bounce 0 left them (the put
    at the end of the step writes into them), and the plain take and put
    of the tool move them back where they were."""
    monkeypatch.setattr(P, "PATH_COMPACT_MIN_B", 256)
    ctx, cam, film, sampler, integ, _ = build_dragon(sub=3, res=(32, 32),
                                                     device="cpu")
    r = Renderer(integ.li, cam, film, sampler, RenderConfig(max_lanes=256),
                 device="cpu")
    cap = capture_step(r, ctx, r.tiles[0])
    assert len(cap["k7"]) == 1
    case = cap["k7"][0]
    fields, order, w = case["fields"], case["order"], case["w"]
    assert w == 64 and len(fields) == len(P.SLAB_FIELDS) + 2
    assert all(f.shape[0] == 256 for f in fields)
    assert sorted(order.tolist()) == list(range(256))
    take, subs = B.k7_call(None, case, False)
    take()
    put, full = B.k7_call(None, case, True, subs)
    put()
    sel = order[:w].long()
    for f, s, g in zip(fields, subs, full):
        assert torch.equal(s, f[sel]) and torch.equal(g[sel], f[sel])
    # a lane's order id, and its 90 bytes of fields (eta_scale's 4
    # among them) read and written once
    assert B.k7_moved(fields, w) == w * (4 + 2 * 90)


SASS = """
        code for sm_90a
                Function : _Z1kPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/    LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
        /*0010*/    LDG.E.64.CONSTANT R2, desc[UR4][R2.64] ; /* 0x0000000402 */
        /*0020*/    @P0 EXIT ;                          /* 0x000000000000094d */
        /*0030*/    @!P1 REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU desc[UR4][R6.64], R8 ;
                                                        /* 0x000fe2000c12f304 */
        /*0040*/    STS [R0], R3 ;                      /* 0x0000000300007388 */
                Function : _Z1jPi
        /*0000*/    STG.E.U8 desc[UR4][R2.64], R5 ;     /* 0x0000000502007986 */
        /*0010*/    BRA 0x10;                           /* 0xfffffffc00fc7947 */
"""


def test_sass_memory_ops_in_program_order():
    """The loads, stores and reductions of each kernel, predicates
    dropped, modifiers kept; other instructions and encodings skipped."""
    assert B.memory_ops(SASS) == {
        "_Z1kPf": ["LDG.E.64.CONSTANT", "REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU",
                   "STS"],
        "_Z1jPi": ["STG.E.U8"]}
