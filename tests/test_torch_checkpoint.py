"""Film checkpoints of the port (render/checkpoint.py, Renderer.
render_checkpointed) and the plain version of K4d, the deterministic splat:
tests/test_checkpoint.py's three cases on a 16^2 Cornell box under the
normal integrator (the round trip; a resume after 3 of 6 spp bit for bit
with the plain render, the file removed; a fresh checkpointed run equal to
the plain render), the same with a Mitchell filter over several tiles
(resumed equal to uninterrupted checkpointed, bit for bit; K4d's plain
version against add_samples_plain within float rounding), and checkpoint
files read across the two packages (arrays only, no JAX render).

Tolerance: bit for bit, except K4d against K4's plain version (sums in
another order: 1e-5 relative, 1e-6 absolute)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.render.checkpoint import \
    load_film_checkpoint as jax_load
from rustracer_tpu.render.checkpoint import \
    save_film_checkpoint as jax_save
from rustracer_tpu.render.film import Film as JaxFilm
from rustracer_tpu.render.film import FilmState as JaxFilmState
from rustracer_tpu.render.filters import Filter as JaxFilter
from rustracer_tpu_torch.integrators.normal import NormalIntegrator
from rustracer_tpu_torch.render.checkpoint import (load_film_checkpoint,
                                                   maybe_resume,
                                                   save_film_checkpoint)
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.filters import Filter
from rustracer_tpu_torch.render.renderer import (RenderConfig, RenderContext,
                                                 Renderer)
from rustracer_tpu_torch.render.sampler import SamplerConfig
from rustracer_tpu_torch.scenes import cornell_box, cornell_camera

torch.set_num_threads(1)

RES = (16, 16)


def _setup(spp=8, filt=None, max_lanes=256):
    geom, lights = cornell_box(device="cpu")
    film = Film(full_resolution=RES, filter=filt or Filter("box", 0.5, 0.5))
    r = Renderer(NormalIntegrator().li, cornell_camera(RES), film,
                 SamplerConfig(kind="02sequence", spp=spp),
                 RenderConfig(max_lanes=max_lanes), device="cpu")
    return RenderContext(geom=geom, lights=lights), r


def _bits(t):
    return t.numpy().view(np.int32)


def test_save_load_roundtrip(tmp_path):
    ctx, r = _setup()
    state = r.render_state(ctx, sample_stop=2)
    p = str(tmp_path / "film.ckpt")
    save_film_checkpoint(p, state, 2)
    loaded, done = load_film_checkpoint(p, r.film)
    assert done == 2 and loaded.splat is None
    for a, b in zip(state[:2], loaded[:2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the packed buffer K4 and K4d take
    assert loaded.wsum.data_ptr() == loaded.rgb.data_ptr() + 12


def test_resume_bit_identical(tmp_path):
    ctx, r = _setup(spp=6)
    want = r.render(ctx)
    # a crash after 3 of 6 spp: checkpoint, then resume
    p = str(tmp_path / "film.ckpt")
    save_film_checkpoint(p, r.render_state(ctx, sample_stop=3), 3)
    got = r.render_checkpointed(ctx, p, every_spp=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not os.path.exists(p)


def test_checkpointed_fresh_run_matches(tmp_path):
    ctx, r = _setup(spp=5)
    want = r.render(ctx)
    got = r.render_checkpointed(ctx, str(tmp_path / "f.ckpt"), every_spp=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mitchell_resume_over_tiles(tmp_path):
    """PBRT's Mitchell filter (radius 2) in 64-lane tiles of the 20 x 20
    sample bounds: a checkpointed render stopped after 2 of 4 samples and
    resumed by a fresh Renderer gives the bits of one run without a stop,
    and the checkpoint holds the same state as a render of samples 0-1
    through K4d's plain version."""
    mitchell = Filter("mitchell", 2.0, 2.0, b=1 / 3, c=1 / 3)
    ctx, r = _setup(spp=4, filt=mitchell, max_lanes=64)
    assert len(r.tiles) > 4
    want = r.render_checkpointed(ctx, str(tmp_path / "a.ckpt"), every_spp=2)
    p = str(tmp_path / "b.ckpt")
    state = r.render_state(ctx, sample_stop=2, deterministic=True)
    save_film_checkpoint(p, state, 2)
    resumed, done = maybe_resume(p, r.film)
    assert done == 2
    np.testing.assert_array_equal(_bits(resumed.rgb), _bits(state.rgb))
    got = _setup(spp=4, filt=mitchell, max_lanes=64)[1] \
        .render_checkpointed(ctx, p, every_spp=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not os.path.exists(p)
    # the atomic-order render agrees to float rounding
    torch.testing.assert_close(r.render(ctx), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["box", "mitchell"])
def test_det_splat_plain_against_k4_plain(kind):
    """K4d's plain version on one tile of seeded samples (some invalid,
    the luminance clamp on) against K4's plain version, within float
    rounding; a sample outside its lane's pixel raises."""
    filt = Filter("box", 0.5, 0.5) if kind == "box" else \
        Filter("mitchell", 2.0, 2.0, b=1 / 3, c=1 / 3)
    film = Film(full_resolution=(24, 16), filter=filt,
                crop_window=(0.1, 0.0, 0.9, 1.0), max_sample_luminance=3.0)
    sx0, sy0, sx1, sy1 = film.get_sample_bounds()
    first, n = 37, 150
    lx, ly, _ = film.lane_pixels(first, n, "cpu")
    rs = np.random.default_rng(5)
    p_film = torch.stack([lx, ly], -1).float() + torch.as_tensor(
        rs.random((n, 2)), dtype=torch.float32)
    rad = torch.as_tensor(rs.random((n, 3)) * 4.0, dtype=torch.float32)
    valid = torch.as_tensor(rs.random(n) > 0.1)
    det = film.add_samples_det(film.init_state("cpu"), p_film, rad, valid,
                               first)
    ref = film.add_samples_plain(film.init_state("cpu"), p_film, rad, valid)
    assert float(det.wsum.sum()) > 0
    for a, b in zip(det[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    again = film.add_samples_det(film.init_state("cpu"), p_film, rad, valid,
                                 first)
    np.testing.assert_array_equal(_bits(again.rgb), _bits(det.rgb))
    with pytest.raises(ValueError, match="renderer's lanes"):
        film.add_samples_det(film.init_state("cpu"), p_film.flip(0), rad,
                             None, first)


# K4d's plain version against the JAX package's splat: (filter, film,
# crop, the lanes' first index and count). Each run of lanes starts and
# ends mid-row; the 3-wide Gaussian's footprint is wider than the CUDA
# kernel's tiles take.
DET_JAX_CASES = {
    "mitchell mid-row": (("mitchell", 2.0, 2.0), (23, 17), (0, 0, 1, 1),
                         61, 200),
    "triangle crop": (("triangle", 1.3, 1.9), (30, 20),
                      (0.1, 0.15, 0.8, 0.95), 45, 260),
    "gaussian wide": (("gaussian", 3.0, 3.0), (20, 14), (0, 0, 1, 1), 29,
                      300),
}


@pytest.mark.parametrize("case", list(DET_JAX_CASES))
def test_det_splat_plain_matches_jax(case):
    """K4d's plain version (Film.add_samples_det_plain) on a run of a
    renderer's lanes that starts and ends mid-row (some invalid, the
    luminance clamp on) against the JAX package's Film.add_samples on the
    same samples: within float rounding (its sums in another order: 1e-5
    relative, 1e-6 absolute)."""
    (kind, rx, ry), res, crop, first, n = DET_JAX_CASES[case]
    film = Film(full_resolution=res, filter=Filter(kind, rx, ry),
                crop_window=crop, max_sample_luminance=3.0)
    jfilm = JaxFilm(full_resolution=res, filter=JaxFilter(kind, rx, ry),
                    crop_window=crop, max_sample_luminance=3.0)
    sx0, sy0, sx1, sy1 = film.get_sample_bounds()
    assert first % (sx1 - sx0) and (first + n) % (sx1 - sx0)
    assert first + n <= (sx1 - sx0) * (sy1 - sy0)
    lx, ly, _ = film.lane_pixels(first, n, "cpu")
    rs = np.random.default_rng(first)
    p_film = (np.stack([lx.numpy(), ly.numpy()], -1)
              + rs.random((n, 2))).astype(np.float32)
    rad = (rs.random((n, 3)) * 5.0).astype(np.float32)
    valid = rs.random(n) > 0.15
    det = film.add_samples_det_plain(film.init_state("cpu"),
                                     torch.as_tensor(p_film),
                                     torch.as_tensor(rad),
                                     torch.as_tensor(valid), first)
    ref = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p_film),
                            jnp.asarray(rad), valid=jnp.asarray(valid))
    assert float(det.wsum.sum()) > 0
    for a, b in ((det.rgb, ref.rgb), (det.wsum, ref.wsum)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_file_interchange(tmp_path):
    """A checkpoint of the JAX package loads in the port (the packed
    buffer), and one of the port loads in the JAX package, with equal
    arrays and samples_done."""
    rs = np.random.default_rng(9)
    rgb = rs.random((16, 24, 3)).astype(np.float32)
    wsum = rs.random((16, 24)).astype(np.float32)
    p = str(tmp_path / "jax.npz")
    jax_save(p, JaxFilmState(rgb=jnp.asarray(rgb), wsum=jnp.asarray(wsum),
                             splat=jnp.zeros((16, 24, 3), jnp.float32)), 5)
    film = Film(full_resolution=(24, 16))
    state, done = load_film_checkpoint(p, film)
    assert done == 5 and state.splat is None
    np.testing.assert_array_equal(state.rgb.numpy(), rgb)
    np.testing.assert_array_equal(state.wsum.numpy(), wsum)

    splat = rs.random((16, 24, 3)).astype(np.float32)
    state = state._replace(splat=torch.as_tensor(splat))
    q = str(tmp_path / "port.npz")
    save_film_checkpoint(q, state, 7)
    jstate, jdone = jax_load(q)
    assert jdone == 7
    for a, b in zip(jstate, (rgb, wsum, splat)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back, _ = load_film_checkpoint(q, film)
    np.testing.assert_array_equal(back.splat.numpy(), splat)
