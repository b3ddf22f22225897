"""Port parity: the film splat (plain version of kernel K4) and to_image
against the JAX package, with a crop window, samples outside the crop,
invalid lanes, the luminance clamp and box widths of 1, 2 and 3 taps an
axis (overlapping taps); and the film state's layout: one (H, W, 4) buffer
seen as the reference's (H, W, 3) and (H, W) sums.

Tolerance: 1e-6 relative (and 1e-6 absolute): scatter-adds of float32 in
another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.render.film import Film as JaxFilm
from rustracer_tpu.render.filters import Filter as JaxFilter
from rustracer_tpu_torch.render.film import Film, FilmState
from rustracer_tpu_torch.render.filters import Filter

torch.set_num_threads(1)


@pytest.mark.parametrize("width", [0.5, 1.0, 1.5])
@pytest.mark.parametrize("max_lum", [float("inf"), 0.8])
def test_add_samples_and_to_image(max_lum, width):
    rs = np.random.default_rng(int(max_lum) if np.isfinite(max_lum) else 9)
    res, crop = (40, 24), (0.1, 0.2, 0.85, 0.9)
    n = 8192
    p_film = (rs.uniform(-2, 1, (n, 2)) + rs.uniform(0, 1, (n, 2))
              * [res[0] + 2, res[1] + 2]).astype(np.float32)
    p_film[:16] = np.floor(p_film[:16])         # jitter exactly 0
    rad = rs.exponential(0.5, (n, 3)).astype(np.float32)
    valid = rs.uniform(size=n) > 0.1
    jfilm = JaxFilm(full_resolution=res, crop_window=crop,
                    filter=JaxFilter("box", width, width),
                    max_sample_luminance=max_lum)
    film = Film(full_resolution=res, crop_window=crop,
                filter=Filter("box", width, width),
                max_sample_luminance=max_lum)
    assert film.get_sample_bounds() == jfilm.get_sample_bounds()
    js = jfilm.init_state()
    for k in range(2):           # two batches accumulate
        sl = slice(k * n // 2, (k + 1) * n // 2)
        js = jfilm.add_samples(js, jnp.asarray(p_film[sl]),
                               jnp.asarray(rad[sl]),
                               valid=jnp.asarray(valid[sl]))
    st = film.init_state(device="cpu")
    for k in range(2):
        sl = slice(k * n // 2, (k + 1) * n // 2)
        st = film.add_samples(st, torch.tensor(p_film[sl]),
                              torch.tensor(rad[sl]),
                              valid=torch.tensor(valid[sl]))
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(js.rgb),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.wsum.numpy(), np.asarray(js.wsum))
    np.testing.assert_allclose(film.to_image(st).numpy(),
                               np.asarray(jfilm.to_image(js)),
                               rtol=1e-6, atol=1e-6)
    assert (st.wsum.numpy() > 0).mean() > 0.9


def test_init_state_is_one_buffer():
    """rgb and wsum are the [..., :3] and [..., 3] views of one (H, W, 4)
    float32 buffer, 16 bytes a pixel, at zero."""
    film = Film(full_resolution=(40, 24), crop_window=(0.1, 0.2, 0.85, 0.9))
    st = film.init_state(device="cpu")
    w, h = film.cropped_resolution
    base = st.rgb._base
    assert base is not None and st.wsum._base is base
    assert base.shape == (h, w, 4) and base.dtype == torch.float32
    assert base.is_contiguous() and not base.any()
    assert st.rgb.shape == (h, w, 3) and st.rgb.stride() == (4 * w, 4, 1)
    assert st.wsum.shape == (h, w) and st.wsum.stride() == (4 * w, 4)
    assert st.rgb.data_ptr() == base.data_ptr()
    assert st.wsum.data_ptr() == base.data_ptr() + 12
    st.rgb[1, 2] = torch.tensor([1.0, 2.0, 3.0])
    st.wsum[1, 2] = 4.0
    assert base[1, 2].tolist() == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("width", [0.5, 1.5])
def test_packed_state_splats_like_separate_sums(width):
    """The plain splat into the packed state equals, bit for bit, the
    splat into separate (H, W, 3) and (H, W) tensors, and to_image of the
    two is the same image."""
    rs = np.random.default_rng(5)
    res, crop = (40, 24), (0.1, 0.2, 0.85, 0.9)
    n = 4096
    p_film = torch.tensor(rs.uniform(-2, 42, (n, 2)).astype(np.float32))
    p_film[:16] = torch.floor(p_film[:16])       # jitter exactly 0
    rad = torch.tensor(rs.exponential(0.5, (n, 3)).astype(np.float32))
    valid = torch.tensor(rs.uniform(size=n) > 0.1)
    film = Film(full_resolution=res, crop_window=crop,
                filter=Filter("box", width, width),
                max_sample_luminance=1.5)
    w, h = film.cropped_resolution
    packed = film.init_state(device="cpu")
    apart = FilmState(rgb=torch.zeros(h, w, 3), wsum=torch.zeros(h, w))
    for st in (packed, apart):
        for k in range(2):
            sl = slice(k * n // 2, (k + 1) * n // 2)
            film.add_samples(st, p_film[sl], rad[sl], valid=valid[sl])
    assert torch.equal(packed.rgb.view(torch.int32),
                       apart.rgb.view(torch.int32))
    assert torch.equal(packed.wsum.view(torch.int32),
                       apart.wsum.view(torch.int32))
    img = film.to_image(packed)
    assert img.shape == (h, w, 3) and img.is_contiguous()
    assert torch.equal(img.view(torch.int32),
                       film.to_image(apart).view(torch.int32))
    assert (packed.wsum > 0).float().mean() > 0.5


@pytest.mark.parametrize("width", [0.5, 1.5])
@pytest.mark.parametrize("max_lum", [float("inf"), 0.8])
def test_add_samples_vjp_matches_jax(max_lum, width):
    """The splat's autograd Function (K4 forward, its CPU backward K9's
    plain version) against ``jax.vjp`` of the JAX splat: the radiance's
    gradient for a random cotangent of both sums, within 1e-6 relative and
    absolute (the same few taps a sample, float32); the film's gradient
    passes through unchanged; the K9 plain version equals autograd of the
    out-of-place plain splat to float rounding. With the luminance clamp
    the gradient subtracts a term of the sample's whole radiance, which
    can cancel: 1e-5 there."""
    rs = np.random.default_rng(3)
    res, crop = (40, 24), (0.1, 0.2, 0.85, 0.9)
    n = 4096
    p_film = rs.uniform(-2, 42, (n, 2)).astype(np.float32)
    p_film[:16] = np.floor(p_film[:16])
    rad = rs.exponential(0.5, (n, 3)).astype(np.float32)
    valid = rs.uniform(size=n) > 0.1
    jfilm = JaxFilm(full_resolution=res, crop_window=crop,
                    filter=JaxFilter("box", width, width),
                    max_sample_luminance=max_lum)
    film = Film(full_resolution=res, crop_window=crop,
                filter=Filter("box", width, width),
                max_sample_luminance=max_lum)
    w, h = film.cropped_resolution
    c_rgb = rs.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    c_w = rs.uniform(-1, 1, (h, w)).astype(np.float32)

    js0 = jfilm.init_state()
    _, vjp = jax.vjp(lambda r: jfilm.add_samples(js0, jnp.asarray(p_film), r,
                                                 valid=jnp.asarray(valid)),
                     jnp.asarray(rad))
    ref = np.asarray(vjp(js0._replace(rgb=jnp.asarray(c_rgb),
                                      wsum=jnp.asarray(c_w)))[0])

    base = torch.zeros((h, w, 4), requires_grad=True)
    acc = base.clone()
    st = FilmState(rgb=acc[..., :3], wsum=acc[..., 3])
    r = torch.tensor(rad, requires_grad=True)
    st = film.add_samples(st, torch.tensor(p_film), r,
                          valid=torch.tensor(valid))
    assert st.rgb.grad_fn is not None and st.rgb._base is acc
    ((st.rgb * torch.tensor(c_rgb)).sum()
     + (st.wsum * torch.tensor(c_w)).sum()).backward()
    tol = 1e-6 if np.isinf(max_lum) else 1e-5
    np.testing.assert_allclose(r.grad.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        base.grad.numpy(), np.concatenate([c_rgb, c_w[..., None]], -1))

    r2 = torch.tensor(rad, requires_grad=True)
    apart = FilmState(rgb=torch.zeros(h, w, 3), wsum=torch.zeros(h, w))
    out = film.add_samples_plain(apart, torch.tensor(p_film), r2,
                                 valid=torch.tensor(valid))
    (out.rgb * torch.tensor(c_rgb)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), r2.grad.numpy(), rtol=tol,
                               atol=tol)
    assert not apart.rgb.any()          # the plain splat went out of place
