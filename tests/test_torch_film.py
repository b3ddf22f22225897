"""Port parity: the film splat (plain version of kernel K4) and to_image
against the JAX package, with a crop window, samples outside the crop,
invalid lanes and the luminance clamp.

Tolerance: 1e-6 relative (and 1e-6 absolute): scatter-adds of float32 in
another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.render.film import Film as JaxFilm
from rustracer_tpu.render.filters import Filter as JaxFilter
from rustracer_tpu_torch.render.film import Film
from rustracer_tpu_torch.render.filters import Filter

torch.set_num_threads(1)


@pytest.mark.parametrize("max_lum", [float("inf"), 0.8])
def test_add_samples_and_to_image(max_lum):
    rs = np.random.default_rng(int(max_lum) if np.isfinite(max_lum) else 9)
    res, crop = (40, 24), (0.1, 0.2, 0.85, 0.9)
    n = 8192
    p_film = (rs.uniform(-2, 1, (n, 2)) + rs.uniform(0, 1, (n, 2))
              * [res[0] + 2, res[1] + 2]).astype(np.float32)
    p_film[:16] = np.floor(p_film[:16])         # jitter exactly 0
    rad = rs.exponential(0.5, (n, 3)).astype(np.float32)
    valid = rs.uniform(size=n) > 0.1
    jfilm = JaxFilm(full_resolution=res, crop_window=crop,
                    filter=JaxFilter("box", 0.5, 0.5),
                    max_sample_luminance=max_lum)
    film = Film(full_resolution=res, crop_window=crop,
                filter=Filter("box", 0.5, 0.5), max_sample_luminance=max_lum)
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
