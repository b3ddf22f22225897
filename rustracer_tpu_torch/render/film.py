"""Film: filter-weighted sample accumulation (port of
rustracer_tpu/render/film.py) with hand kernel K4 (csrc/film.cu).

K4 and its transpose K9 take every filter of render/filters.py: the box,
triangle, Gaussian and Mitchell weights over a footprint of ceil(2r)^2
taps (csrc/filter.cuh, the same weights as ``Filter.evaluate``).

Unlike the reference's functional state, ``add_samples`` adds into the
state's tensors in place: the film is 16 MB at 1024^2 and the render loop
owns it. The state is one (H, W, 4) float32 buffer, r, g, b and the weight
side by side for each pixel, seen through the reference's two arrays:
``rgb`` is its view ``[..., :3]`` and ``wsum`` its view ``[..., 3]``. K4
adds each filter tap as one 16-byte vector reduction into that buffer.

Under autograd (grad mode on, radiance requiring grad) the splat of a
packed state is an autograd Function: the buffer is still added to in
place (marked dirty) and its gradient passes through unchanged; the
radiance's gradient is hand kernel K9 (csrc/film_bwd.cu), the gather of
the film's gradient at the same taps, times the filter weights, through
the VJP of the luminance clamp. ``wsum`` takes no gradient: it depends on
``p_film`` only.

``add_samples_det`` is the splat of the checkpointed render, hand kernel
K4d (csrc/film.cu): the same taps as K4, each pixel's sum taken in a fixed
order (ascending lane) and added once, so that its bits do not depend on
the order in which the card runs the taps. It takes the renderer's lanes
(a contiguous run of the row-major pixels of ``get_sample_bounds``, one
sample a lane) and raises for any other layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import cuda
from ..core.spectrum import LUM_WEIGHTS, luminance
from .filters import Filter


class FilmState(NamedTuple):
    rgb: torch.Tensor    # (H, W, 3) filter-weighted radiance sum
    wsum: torch.Tensor   # (H, W) filter weight sum
    # (H, W, 3) unweighted splats, made by the first ``add_splats``
    splat: Optional[torch.Tensor] = None


def _check_film(state: FilmState, h, w, device):
    """Raise unless ``state`` is the two views of one 16-byte aligned
    (H, W, 4) float32 buffer that ``Film.init_state`` makes (K4 adds r, g,
    b and the weight of a tap with one 16-byte reduction)."""
    rgb, wsum = state.rgb, state.wsum
    if not (rgb.dtype == wsum.dtype == torch.float32
            and rgb.device == wsum.device == device
            and tuple(rgb.shape) == (h, w, 3)
            and rgb.stride() == (4 * w, 4, 1) and wsum.stride() == (4 * w, 4)
            and wsum.data_ptr() == rgb.data_ptr() + 12
            and rgb.data_ptr() % 16 == 0):
        raise ValueError(
            "film state: K4 takes rgb and wsum as the [..., :3] and [..., 3] "
            "views of one 16-byte aligned (H, W, 4) float32 buffer on "
            f"{device} (Film.init_state); got rgb {rgb.dtype} "
            f"{tuple(rgb.shape)} strides {rgb.stride()} on {rgb.device}, "
            f"wsum strides {wsum.stride()}, {wsum.data_ptr() - rgb.data_ptr()}"
            " bytes after rgb")


@dataclasses.dataclass(frozen=True)
class Film:
    full_resolution: Tuple[int, int] = (1280, 720)   # (x, y)
    crop_window: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    filter: Filter = dataclasses.field(default_factory=Filter)
    filename: str = "out.png"
    scale: float = 1.0
    max_sample_luminance: float = float("inf")
    diagonal: float = 0.035

    @property
    def cropped_pixel_bounds(self):
        """(x0, y0, x1, y1) integer pixel bounds."""
        xr, yr = self.full_resolution
        cx0, cy0, cx1, cy1 = self.crop_window
        x0 = int(np.ceil(xr * cx0))
        x1 = max(x0 + 1, int(np.ceil(xr * cx1)))
        y0 = int(np.ceil(yr * cy0))
        y1 = max(y0 + 1, int(np.ceil(yr * cy1)))
        return (x0, y0, x1, y1)

    @property
    def cropped_resolution(self):
        x0, y0, x1, y1 = self.cropped_pixel_bounds
        return (x1 - x0, y1 - y0)

    def get_sample_bounds(self):
        """Pixel sample bounds expanded by the filter radius."""
        x0, y0, x1, y1 = self.cropped_pixel_bounds
        rx, ry = self.filter.radius
        return (int(np.floor(x0 + 0.5 - rx)), int(np.floor(y0 + 0.5 - ry)),
                int(np.ceil(x1 - 0.5 + rx)), int(np.ceil(y1 - 0.5 + ry)))

    def init_state(self, device="cuda") -> FilmState:
        w, h = self.cropped_resolution
        acc = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
        return FilmState(rgb=acc[..., :3], wsum=acc[..., 3])

    def _footprint(self):
        rx, ry = self.filter.radius
        return max(int(math.ceil(2.0 * rx)), 1), max(int(math.ceil(2.0 * ry)), 1)

    def taps(self, p_film, valid, h, w):
        """The filter footprint of samples ``p_film`` (B, 2) on an (h, w)
        film, one tap at a time -> (iy, ix, fw, ok) each (B,): the tap's
        film row and column, its filter weight, and whether it lands (the
        sample is valid, the pixel inside the crop, the weight above 0)."""
        x0, y0, _, _ = self.cropped_pixel_bounds
        rx, ry = self.filter.radius
        nx, ny = self._footprint()
        p_lo_x = torch.ceil(p_film[:, 0] - 0.5 - rx).int()
        p_lo_y = torch.ceil(p_film[:, 1] - 0.5 - ry).int()
        if valid is None:
            valid = torch.ones_like(p_lo_x, dtype=torch.bool)
        for j in range(ny):
            for i in range(nx):
                px, py = p_lo_x + i, p_lo_y + j
                fw = self.filter.evaluate(px.float() + 0.5 - p_film[:, 0],
                                          py.float() + 0.5 - p_film[:, 1])
                ix, iy = px - x0, py - y0
                ok = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) \
                    & (fw > 0.0)
                yield iy, ix, fw, ok

    def _clamped(self, radiance):
        """The radiance scaled down to ``max_sample_luminance``: the scale
        max / lum one rounded division, as the reference and K4 take it
        (a number over a tensor, ``m / t``, is ``t.reciprocal() * m`` in
        torch: two roundings)."""
        if not np.isfinite(self.max_sample_luminance):
            return radiance
        lum = luminance(radiance)
        m = lum.new_full((), self.max_sample_luminance)
        scale = torch.where(lum > m, m / torch.clamp(lum, min=1e-20), 1.0)
        return radiance * scale[:, None]

    def add_samples_plain(self, state: FilmState, p_film, radiance,
                          valid=None) -> FilmState:
        """Plain PyTorch version of K4: scatter-add of the filter taps, in
        place; out of place (a new state of two tensors, which autograd
        differentiates) when grad mode is on and the radiance or the state
        requires grad."""
        h, w = state.wsum.shape
        radiance = self._clamped(radiance)
        rgb, wsum = state.rgb, state.wsum
        graph = torch.is_grad_enabled() and (radiance.requires_grad
                                             or rgb.requires_grad)
        for iy, ix, fw, ok in self.taps(p_film, valid, h, w):
            fw = torch.where(ok, fw, 0.0)
            idx = (iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long())
            if graph:
                rgb = rgb.index_put(idx, fw[:, None] * radiance,
                                    accumulate=True)
                wsum = wsum.index_put(idx, fw, accumulate=True)
            else:
                rgb.index_put_(idx, fw[:, None] * radiance, accumulate=True)
                wsum.index_put_(idx, fw, accumulate=True)
        return FilmState(rgb=rgb, wsum=wsum, splat=state.splat)

    def add_samples(self, state: FilmState, p_film, radiance,
                    valid=None) -> FilmState:
        """Splat samples (p_film (B, 2) raster positions, radiance (B, 3),
        valid (B,) bool or None) into ``state`` in place. CPU tensors take
        the plain version, CUDA tensors launch K4. With grad mode on and
        the radiance requiring grad, a packed state (``init_state``) is
        splatted through an autograd Function (K4 forward, K9 backward);
        any other state on the CPU through the plain version, out of
        place."""
        if torch.is_grad_enabled() and radiance.requires_grad:
            acc = _packed(state)
            if acc is not None:
                acc = _Splat.apply(acc, p_film, radiance, valid, self)
                return FilmState(rgb=acc[..., :3], wsum=acc[..., 3],
                                 splat=state.splat)
        return self._add_samples(state, p_film, radiance, valid)

    def _add_samples(self, state, p_film, radiance, valid):
        if not cuda.use_kernel(p_film):
            return self.add_samples_plain(state, p_film, radiance, valid)
        n = p_film.shape[0]
        dev = p_film.device
        h, w = state.wsum.shape
        cuda.check(p_film, "p_film", torch.float32, (n, 2), dev, align=8)
        cuda.check(radiance, "radiance", torch.float32, (n, 3), dev)
        if valid is not None:
            cuda.check(valid, "valid", torch.bool, (n,), dev)
        _check_film(state, h, w, dev)
        x0, y0, _, _ = self.cropped_pixel_bounds
        rx, ry = self.filter.radius
        nx, ny = self._footprint()
        kind, fp = self.filter.kernel_params()
        if n:
            cuda.launch("film_add_samples", p_film, radiance, valid, n,
                        state.rgb, state.wsum, h, w, x0, y0, rx, ry, nx, ny,
                        self.max_sample_luminance, kind, *fp)
        return state

    def det_window(self):
        """-> (olx, ohx, oly, ohy): the offsets of a tap's pixel from the
        pixel P of its sample (P <= p_film <= P + 1 on each axis), widened
        by one on each side against rounding; every tap lies within."""
        nx, ny = self._footprint()
        rx, ry = self.filter.radius
        return (math.ceil(-0.5 - rx) - 1, math.ceil(0.5 - rx) + nx,
                math.ceil(-0.5 - ry) - 1, math.ceil(0.5 - ry) + ny)

    def lane_pixels(self, first: int, n: int, device):
        """The pixel (x, y) (B,) int64 each and the row-major index in the
        sample bounds of lanes [first, first + n) of the renderer's
        layout."""
        sx0, sy0, sx1, _ = self.get_sample_bounds()
        g = first + torch.arange(n, device=device)
        return sx0 + g % (sx1 - sx0), sy0 + g // (sx1 - sx0), g

    def check_det_layout(self, p_film, valid, first: int):
        """Raise unless every valid lane of ``p_film`` lies in its pixel of
        the renderer's layout from lane ``first`` (one host sync)."""
        sx0, sy0, sx1, sy1 = self.get_sample_bounds()
        n = p_film.shape[0]
        lx, ly, g = self.lane_pixels(first, n, p_film.device)
        ok = (g < (sx1 - sx0) * (sy1 - sy0)) \
            & (p_film[:, 0] >= lx) & (p_film[:, 0] <= lx + 1) \
            & (p_film[:, 1] >= ly) & (p_film[:, 1] <= ly + 1)
        if valid is not None:
            ok = ok | ~valid
        if not bool(ok.all()):
            raise ValueError(
                "add_samples_det: the samples are not the renderer's lanes "
                f"from lane {first} (row-major pixels of the sample bounds "
                f"{(sx0, sy0, sx1, sy1)}, each sample inside its pixel)")

    def add_samples_det_plain(self, state: FilmState, p_film, radiance,
                              valid=None, first: int = 0) -> FilmState:
        """Plain PyTorch version of K4d, in place: each film pixel's taps
        summed in ascending lane order from 0 (one ``index_put_`` pass per
        offset of the window, from the last offset to the first: a pass's
        targets are distinct lanes' pixels), the sums added once."""
        h, w = state.wsum.shape
        x0, y0, _, _ = self.cropped_pixel_bounds
        rx, ry = self.filter.radius
        nx, ny = self._footprint()
        radiance = self._clamped(radiance)
        lx, ly, _ = self.lane_pixels(first, p_film.shape[0], p_film.device)
        lo_x = torch.ceil(p_film[:, 0] - 0.5 - rx).long()
        lo_y = torch.ceil(p_film[:, 1] - 0.5 - ry).long()
        lane_ok = torch.ones_like(lx, dtype=torch.bool) if valid is None \
            else valid
        tmp = torch.zeros((h, w, 4), dtype=torch.float32,
                          device=p_film.device)
        olx, ohx, oly, ohy = self.det_window()
        for oy in range(ohy, oly - 1, -1):
            for ox in range(ohx, olx - 1, -1):
                tx, ty = lx + ox, ly + oy
                fw = self.filter.evaluate(tx.float() + 0.5 - p_film[:, 0],
                                          ty.float() + 0.5 - p_film[:, 1])
                ix, iy = tx - x0, ty - y0
                ok = lane_ok & (tx - lo_x >= 0) & (tx - lo_x < nx) \
                    & (ty - lo_y >= 0) & (ty - lo_y < ny) & (ix >= 0) \
                    & (ix < w) & (iy >= 0) & (iy < h) & (fw > 0.0)
                vals = torch.cat([fw[:, None] * radiance, fw[:, None]], -1)
                tmp.index_put_((iy[ok], ix[ok]), vals[ok], accumulate=True)
        state.rgb.add_(tmp[..., :3])
        state.wsum.add_(tmp[..., 3])
        return state

    def add_samples_det(self, state: FilmState, p_film, radiance,
                        valid=None, first: int = 0) -> FilmState:
        """Splat the renderer's lanes [first, first + n) (p_film (B, 2),
        radiance (B, 3), valid (B,) bool or None) into ``state`` in place,
        each pixel's sum in a fixed order: the same bits on every run. CPU
        tensors take the plain version, CUDA tensors launch K4d (given a
        state of ``init_state``). Raises for lanes outside that layout."""
        self.check_det_layout(p_film, valid, first)
        if not cuda.use_kernel(p_film):
            return self.add_samples_det_plain(state, p_film, radiance, valid,
                                              first)
        return self._add_samples_det(state, p_film, radiance, valid, first)

    def det_rows(self, first: int, n: int):
        """-> (row0, rows): the film rows the taps of lanes [first, first +
        n) can reach."""
        w, h = self.cropped_resolution
        sx0, sy0, sx1, sy1 = self.get_sample_bounds()
        _, y0, _, _ = self.cropped_pixel_bounds
        sw, sh = sx1 - sx0, sy1 - sy0
        _, _, oly, ohy = self.det_window()
        ga = min(first // sw, sh - 1)
        gb = min((first + max(n, 1) - 1) // sw, sh - 1)
        row0 = max(sy0 + ga + oly - y0, 0)
        row1 = min(sy0 + gb + ohy - y0 + 1, h)
        return row0, max(row1 - row0, 0)

    def _add_samples_det(self, state, p_film, radiance, valid, first,
                         lib=None):
        """K4d's launch (``add_samples_det`` without the layout check;
        ``lib``, a loaded other build, is launched uncounted)."""
        n = p_film.shape[0]
        dev = p_film.device
        h, w = state.wsum.shape
        cuda.check(p_film, "p_film", torch.float32, (n, 2), dev, align=8)
        cuda.check(radiance, "radiance", torch.float32, (n, 3), dev)
        if valid is not None:
            cuda.check(valid, "valid", torch.bool, (n,), dev)
        _check_film(state, h, w, dev)
        x0, y0, _, _ = self.cropped_pixel_bounds
        sx0, sy0, sx1, sy1 = self.get_sample_bounds()
        rx, ry = self.filter.radius
        nx, ny = self._footprint()
        kind, fp = self.filter.kernel_params()
        row0, rows = self.det_rows(first, n)
        if n and rows:
            cuda.launch("film_add_samples_det", p_film, radiance, valid, n,
                        state.rgb, state.wsum, h, w, x0, y0, rx, ry, nx, ny,
                        self.max_sample_luminance, kind, *fp, first, sx0,
                        sy0, sx1 - sx0, sy1 - sy0, *self.det_window(), row0,
                        rows, lib=lib)
        return state

    def clamp_vjp(self, radiance, g):
        """The gradient of the radiance (B, 3) from that of the clamped
        radiance ``g`` (B, 3): the VJP of the ``max_sample_luminance``
        clamp, written out in K9's order of operations."""
        m = self.max_sample_luminance
        if not np.isfinite(m):
            return g
        lum = luminance(radiance)
        over = lum > m
        cl = torch.clamp(lum, min=1e-20)
        scale = torch.where(over, m / cl, 1.0)
        dot = g[:, 0] * radiance[:, 0] + g[:, 1] * radiance[:, 1] \
            + g[:, 2] * radiance[:, 2]
        # d scale / d lum, where the clamp lets lum through
        d_lum = torch.where(over & (lum >= 1e-20), -(dot * m) / (cl * cl),
                            0.0)
        return torch.stack([g[:, c] * scale + d_lum * LUM_WEIGHTS[c]
                            for c in range(3)], -1)

    def add_samples_bwd_plain(self, g_acc, p_film, radiance, valid=None):
        """Plain PyTorch version of K9: the radiance's gradient (B, 3) from
        the film buffer's (H, W, 4): per sample, the sum over its taps, in
        ``taps`` order, of the filter weight times the rgb gradient of the
        tap's pixel, then ``clamp_vjp``."""
        h, w = g_acc.shape[:2]
        g_rgb = g_acc[..., :3]
        g = torch.zeros_like(radiance)
        for iy, ix, fw, ok in self.taps(p_film, valid, h, w):
            fw = torch.where(ok, fw, 0.0)
            idx = (iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long())
            g = g + fw[:, None] * g_rgb[idx]
        return self.clamp_vjp(radiance, g)

    def add_samples_bwd(self, g_acc, p_film, radiance, valid=None):
        """The radiance's gradient of a splat: ``g_acc`` (H, W, 4), the
        gradient of the film buffer, contiguous. CPU tensors take the plain
        version, CUDA tensors launch K9, given the renderer's layout of the
        samples (row-major over ``get_sample_bounds``) as a hint of which
        samples' footprints meet (any order gives the same result)."""
        if not cuda.use_kernel(p_film):
            return self.add_samples_bwd_plain(g_acc, p_film, radiance, valid)
        n = p_film.shape[0]
        dev = p_film.device
        w, h = self.cropped_resolution
        cuda.check(g_acc, "g_acc", torch.float32, (h, w, 4), dev, align=16)
        cuda.check(p_film, "p_film", torch.float32, (n, 2), dev, align=8)
        cuda.check(radiance, "radiance", torch.float32, (n, 3), dev)
        if valid is not None:
            cuda.check(valid, "valid", torch.bool, (n,), dev)
        x0, y0, _, _ = self.cropped_pixel_bounds
        rx, ry = self.filter.radius
        nx, ny = self._footprint()
        sx0, _, sx1, _ = self.get_sample_bounds()
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        kind, fp = self.filter.kernel_params()
        if n:
            cuda.launch("film_add_samples_bwd", p_film, radiance, valid, n,
                        g_acc, h, w, x0, y0, rx, ry, nx, ny,
                        self.max_sample_luminance, kind, *fp, out,
                        sx1 - sx0, sx0)
        return out

    def add_splats(self, state: FilmState, p_film, v,
                   splat_weight=1.0) -> FilmState:
        """Unfiltered splats of ``v`` (B, 3) at raster positions ``p_film``
        (B, 2) into the state's splat buffer, out of place (the buffer is
        made here on first use). Plain PyTorch: no integrator of either
        package calls it (the reference's bidirectional integrators, its
        callers, are not ported there either)."""
        x0, y0, _, _ = self.cropped_pixel_bounds
        h, w = state.wsum.shape
        ix = torch.floor(p_film[:, 0]).int() - x0
        iy = torch.floor(p_film[:, 1]).int() - y0
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        wgt = torch.where(ok, splat_weight, 0.0)
        splat = state.splat if state.splat is not None else torch.zeros(
            (h, w, 3), dtype=torch.float32, device=state.wsum.device)
        splat = splat.index_put((iy.clamp(0, h - 1).long(),
                                 ix.clamp(0, w - 1).long()),
                                wgt[:, None] * v, accumulate=True)
        return state._replace(splat=splat)

    def to_image(self, state: FilmState, splat_scale=1.0):
        """Weight-normalized (H, W, 3) linear RGB, splats added, times the
        film's scale."""
        pos = state.wsum > 0.0
        safe_w = torch.where(pos, state.wsum, 1.0)
        img = torch.where(pos[..., None], state.rgb / safe_w[..., None], 0.0)
        img = torch.clamp(img, min=0.0)
        if state.splat is not None:
            img = img + splat_scale * state.splat
        return img * self.scale if self.scale != 1.0 else img


def _packed(state: FilmState):
    """The (H, W, 4) buffer whose views ``state`` holds (``init_state``),
    or None for another layout."""
    base = state.rgb._base
    h, w = state.wsum.shape
    if (base is None or state.wsum._base is not base
            or tuple(base.shape) != (h, w, 4) or not base.is_contiguous()
            or base.data_ptr() != state.rgb.data_ptr()
            or state.wsum.data_ptr() != base.data_ptr()
            + 3 * base.element_size()):
        return None
    return base


class _Splat(torch.autograd.Function):
    """K4 into the film buffer in place, K9 for the radiance's gradient."""

    @staticmethod
    def forward(ctx, acc, p_film, radiance, valid, film):
        with cuda.differentiable():
            film._add_samples(FilmState(rgb=acc[..., :3], wsum=acc[..., 3]),
                              p_film, radiance, valid)
        ctx.mark_dirty(acc)
        ctx.save_for_backward(p_film, radiance, valid)
        ctx.film = film
        return acc

    @staticmethod
    def backward(ctx, g):
        p_film, radiance, valid = ctx.saved_tensors
        g_rad = None
        if ctx.needs_input_grad[2]:
            with cuda.differentiable():
                g_rad = ctx.film.add_samples_bwd(g.contiguous(), p_film,
                                                 radiance, valid)
        return g, None, g_rad, None, None
