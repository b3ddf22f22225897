"""Port parity of the reconstruction filters, the film and the thin-lens
camera (``rustracer_tpu_torch.render``) against the JAX package's, on the
CPU.

- Every filter (box, triangle, Gaussian, Mitchell, sinc as Mitchell, with
  default and other widths and parameters): weights within 1e-6 of JAX's
  (the exponential of XLA and of torch may differ in the last bit);
  ``make_filter`` builds the same filter.
- ``Film.add_samples_plain`` (the plain version of K4) and
  ``add_samples_bwd_plain`` (of K9) with each filter against JAX's
  ``add_samples`` and its VJP: each film entry and radiance gradient
  within 1e-6 relative (1e-6 absolute): sums of up to 64 taps.
- K4's separable weights (``Filter.axis_weights``): their product equals
  ``evaluate`` bit for bit at every tap, for every kind and radius.
- ``add_splats`` and ``to_image`` with a splat scale and the film's scale.
- Thin-lens rays with differentials within 1e-6 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu.core.transform import Transform as JaxTransform
from rustracer_tpu.render.camera import PerspectiveCamera as JaxCamera
from rustracer_tpu.render.film import Film as JaxFilm
from rustracer_tpu.render.filters import Filter as JaxFilter
from rustracer_tpu.render.filters import make_filter as jax_make_filter
from rustracer_tpu.scene.paramset import ParamSet as JaxParamSet
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.transform import Transform
from rustracer_tpu_torch.render.camera import PerspectiveCamera
from rustracer_tpu_torch.render.filters import Filter, make_filter
from rustracer_tpu_torch.scene.paramset import ParamSet

torch.set_num_threads(1)

FILTERS = {
    "box 0.5": dict(kind="box"),
    "box 1.5": dict(kind="box", xwidth=1.5, ywidth=1.0),
    "triangle": dict(kind="triangle", xwidth=2.0, ywidth=2.0),
    "triangle 1.3": dict(kind="triangle", xwidth=1.3, ywidth=0.7),
    "gaussian": dict(kind="gaussian", xwidth=2.0, ywidth=2.0),
    "gaussian a3": dict(kind="gaussian", xwidth=1.5, ywidth=2.5, alpha=3.0),
    "mitchell": dict(kind="mitchell", xwidth=2.0, ywidth=2.0),
    "mitchell b c": dict(kind="mitchell", xwidth=2.0, ywidth=1.5, b=0.5,
                         c=0.25),
    "sinc (mitchell 4)": dict(kind="mitchell", xwidth=4.0, ywidth=4.0),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_weights(name):
    kw = FILTERS[name]
    f, jf = Filter(**kw), JaxFilter(**kw)
    rng = np.random.RandomState(1)
    rx, ry = f.radius
    d = (rng.rand(4096, 2) * 2 - 1) * (np.array([rx, ry]) + 0.5)
    d[:8] = [[0, 0], [rx, 0], [0, ry], [rx, ry], [-rx, -ry], [0.5, 0.5],
             [rx / 2, ry / 2], [-rx / 4, ry / 3]]
    d = d.astype(np.float32)
    got = f.evaluate(torch.as_tensor(d[:, 0]), torch.as_tensor(d[:, 1]))
    ref = np.asarray(jf.evaluate(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1])))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert (ref > 0).sum() > 100


@pytest.mark.parametrize("name", sorted(FILTERS) + ["triangle 2.5 wide"])
def test_axis_weights_product_is_evaluate(name):
    """K4's separable weights (``Filter.axis_weights``, the plain twin of
    csrc/film.cu's registers): at every tap of a sample's footprint, x
    factor times y factor where both offsets lie inside the extent equals
    ``evaluate`` bit for bit, and JAX's ``evaluate`` within 1e-6; radii
    up to 4 (8 taps an axis, wider than K4's 4-tap register arrays)."""
    kw = FILTERS.get(name, dict(kind="triangle", xwidth=2.5, ywidth=1.2))
    f, jf = Filter(**kw), JaxFilter(**kw)
    rx, ry = f.radius
    nx, ny = max(int(np.ceil(2 * rx)), 1), max(int(np.ceil(2 * ry)), 1)
    rng = np.random.RandomState(7)
    p = (rng.rand(512, 2) * 40).astype(np.float32)
    p[:16] = np.floor(p[:16]) + [[0.0, 0.5]]        # jitter 0 and 0.5
    p = torch.as_tensor(p)
    lo_x = torch.ceil(p[:, 0] - 0.5 - rx).int()
    lo_y = torch.ceil(p[:, 1] - 0.5 - ry).int()
    dx = torch.stack([(lo_x + k).float() + 0.5 - p[:, 0]
                      for k in range(nx)], 1)          # (B, nx)
    dy = torch.stack([(lo_y + j).float() + 0.5 - p[:, 1]
                      for j in range(ny)], 1)          # (B, ny)
    wx, mx, wy, my = f.axis_weights(dx, dy)
    got = torch.where(mx[:, None, :] & my[:, :, None],
                      wx[:, None, :] * wy[:, :, None], 0.0)   # (B, ny, nx)
    tdx = dx[:, None, :].expand(-1, ny, -1)
    tdy = dy[:, :, None].expand(-1, -1, nx)
    ref = f.evaluate(tdx, tdy)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    jref = np.asarray(jf.evaluate(jnp.asarray(tdx.numpy()),
                                  jnp.asarray(tdy.numpy())))
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=1e-6)
    assert (ref > 0).float().mean() > 0.3


@pytest.mark.parametrize("name,params", [
    ("box", {}), ("triangle", {"xwidth": 1.5}), ("gaussian", {"alpha": 3.0}),
    ("mitchell", {"B": 0.5, "C": 0.25}), ("sinc", {"xwidth": 3.0})])
def test_make_filter_equal(name, params):
    jps, ps = JaxParamSet(), ParamSet()
    for k, v in params.items():
        jps.add(k, "float", [v])
        ps.add(k, "float", [v])
    jf, f = jax_make_filter(name, jps), make_filter(name, ps)
    assert dataclass_fields(jf) == dataclass_fields(f)


def dataclass_fields(f):
    return (f.kind, f.xwidth, f.ywidth, f.alpha, f.b, f.c)


def _samples(seed, n, res):
    rng = np.random.RandomState(seed)
    p = (rng.rand(n, 2) * (np.array(res) + 6) - 3).astype(np.float32)
    rad = (rng.rand(n, 3) * 3).astype(np.float32)
    valid = rng.rand(n) > 0.1
    return p, rad, valid


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("crop", [(0.0, 0.0, 1.0, 1.0),
                                  (0.1, 0.2, 0.8, 0.9)],
                         ids=["full", "crop"])
def test_add_samples_plain_and_bwd(name, crop):
    kw = FILTERS[name]
    res = (24, 20)
    jfilm = JaxFilm(full_resolution=res, crop_window=crop,
                    filter=JaxFilter(**kw), max_sample_luminance=6.0)
    film = convert.film_from_jax(jfilm)
    p, rad, valid = _samples(2, 3000, res)
    st = film.add_samples_plain(film.init_state("cpu"), torch.as_tensor(p),
                                torch.as_tensor(rad),
                                valid=torch.as_tensor(valid))
    jst = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p),
                            jnp.asarray(rad), valid=jnp.asarray(valid))
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(jst.rgb),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.wsum.numpy(), np.asarray(jst.wsum),
                               rtol=1e-6, atol=1e-6)
    # the radiance's gradient (K9's plain version) against JAX's VJP
    h, w = st.wsum.shape
    g = np.random.RandomState(3).randn(h, w, 4).astype(np.float32)

    def splat(r):
        s = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p), r,
                              valid=jnp.asarray(valid))
        return jnp.concatenate([s.rgb, s.wsum[..., None]], -1)
    _, vjp = jax.vjp(splat, jnp.asarray(rad))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = film.add_samples_bwd_plain(torch.as_tensor(g), torch.as_tensor(p),
                                     torch.as_tensor(rad),
                                     torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_splats_and_scale():
    res = (16, 12)
    jfilm = JaxFilm(full_resolution=res, crop_window=(0.0, 0.1, 1.0, 1.0),
                    filter=JaxFilter("triangle", 1.0, 1.0), scale=2.5)
    film = convert.film_from_jax(jfilm)
    assert film.scale == 2.5
    p, rad, valid = _samples(4, 400, res)
    sp, sv, _ = _samples(5, 200, res)
    st = film.add_samples_plain(film.init_state("cpu"), torch.as_tensor(p),
                                torch.as_tensor(rad))
    st = film.add_splats(st, torch.as_tensor(sp), torch.as_tensor(sv), 0.5)
    jst = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p),
                            jnp.asarray(rad))
    jst = jfilm.add_splats(jst, jnp.asarray(sp), jnp.asarray(sv), 0.5)
    np.testing.assert_allclose(st.splat.numpy(), np.asarray(jst.splat),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(film.to_image(st, splat_scale=0.3).numpy(),
                               np.asarray(jfilm.to_image(jst, 0.3)),
                               rtol=1e-6, atol=1e-6)
    # no splat buffer until the first add_splats: the image is the same
    st0 = film.add_samples_plain(film.init_state("cpu"), torch.as_tensor(p),
                                 torch.as_tensor(rad))
    assert st0.splat is None
    jst0 = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p),
                             jnp.asarray(rad))
    np.testing.assert_allclose(film.to_image(st0).numpy(),
                               np.asarray(jfilm.to_image(jst0)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lens", [0.0, 0.15], ids=["pinhole", "thin lens"])
def test_thin_lens_rays(lens):
    eye, look, up = [0.3, 1.2, -3.0], [0.0, 0.2, 0.5], [0, 1, 0]
    res = (32, 24)
    kw = dict(fov=40.0, lens_radius=lens, focal_distance=2.7,
              resolution=res, screen_window=(-1.2, 1.2, -0.9, 0.9))
    jcam = JaxCamera.create(JaxTransform.look_at(eye, look, up), **kw)
    cam = PerspectiveCamera.create(Transform.look_at(eye, look, up), **kw)
    np.testing.assert_array_equal(cam.raster_to_camera,
                                  np.asarray(jcam.raster_to_camera))
    conv = convert.camera_from_jax(jcam)
    assert (conv.lens_radius, conv.focal_distance) == (cam.lens_radius,
                                                       cam.focal_distance)
    rng = np.random.RandomState(6)
    p_film = (rng.rand(2048, 2) * np.array(res)).astype(np.float32)
    p_lens = rng.rand(2048, 2).astype(np.float32)
    p_lens[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9], [0.1, 0.5]]
    ray = cam.generate_ray_differential(torch.as_tensor(p_film),
                                        torch.as_tensor(p_lens))
    jray = jcam.generate_ray_differential(jnp.asarray(p_film),
                                          jnp.asarray(p_lens))
    for f in ("o", "d", "rx_origin", "rx_direction", "ry_origin",
              "ry_direction"):
        np.testing.assert_allclose(getattr(ray, f).numpy(),
                                   np.asarray(getattr(jray, f)), rtol=0,
                                   atol=1e-6)
    if lens:
        assert float((ray.o - ray.o[:1]).abs().max()) > 0.01
