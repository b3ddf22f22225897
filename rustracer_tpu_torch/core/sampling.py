"""Monte-Carlo warps and piecewise-constant distributions (port of
rustracer_tpu/core/sampling.py, the subset the render path uses).

``Distribution1D`` and ``Distribution2D`` are built on the host in numpy
float32 and inverted on the device: the cdf is a sequential float32 cumsum
over n (XLA sums the reference's in another order, so the two agree within
n 2^-24 relative, not bit for bit); a row whose function is all zero gets
the uniform cdf and ``func_int`` 0, as the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math import find_interval

PI_OVER_2 = float(np.float32(np.pi / 2.0))
PI_OVER_4 = float(np.float32(np.pi / 4.0))


def concentric_sample_disk(u):
    """Shirley's concentric disk warp, (..., 2) -> (..., 2)."""
    u_off = 2.0 * u - 1.0
    ux, uy = u_off[..., 0], u_off[..., 1]
    both_zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    one = torch.ones_like(ux)
    theta = torch.where(
        use_x, PI_OVER_4 * (uy / torch.where(ux == 0.0, one, ux)),
        PI_OVER_2 - PI_OVER_4 * (ux / torch.where(uy == 0.0, one, uy)))
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(both_zero[..., None], torch.zeros_like(p), p)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def uniform_sample_triangle(u):
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic, beta = 2."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    pos = denom > 0.0
    return torch.where(pos, (f * f) / torch.where(pos, denom,
                                                  torch.ones_like(denom)),
                       torch.zeros_like(denom))


def _take(t, idx):
    """t[..., idx] for one row (N,) with idx (B,), or per-lane rows (B, N)
    with idx (B,)."""
    if t.dim() == 1:
        return t[idx]
    return torch.gather(t, -1, idx[..., None])[..., 0]


def distribution_np(func):
    """Host build of a Distribution1D over the last axis of ``func`` ->
    (func, cdf (..., N + 1), func_int (...)) float32 numpy."""
    func = np.asarray(func, np.float32)
    n = func.shape[-1]
    cdf = np.cumsum(func, axis=-1, dtype=np.float32) / np.float32(n)
    cdf = np.concatenate([np.zeros_like(cdf[..., :1]), cdf], axis=-1)
    func_int = cdf[..., -1].copy()
    uniform = np.arange(n + 1, dtype=np.float32) / np.float32(n)
    pos = func_int > 0.0
    safe = np.where(pos, func_int, np.float32(1.0))
    cdf = np.where(pos[..., None], cdf / safe[..., None],
                   np.broadcast_to(uniform, cdf.shape)).astype(np.float32)
    return func, cdf, func_int


@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant distribution over [0, 1): func (..., N), cdf
    (..., N + 1), func_int (...); a batch of rows when func has more than
    one axis."""
    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @property
    def count(self):
        return self.func.shape[-1]

    def to(self, device) -> "Distribution1D":
        return Distribution1D(self.func.to(device), self.cdf.to(device),
                              self.func_int.to(device))

    @staticmethod
    def create(func, device="cpu") -> "Distribution1D":
        return Distribution1D(*(torch.as_tensor(a, device=device)
                                for a in distribution_np(func)))

    def _safe_int(self):
        pos = self.func_int > 0.0
        return pos, torch.where(pos, self.func_int, 1.0)

    def sample_continuous(self, u):
        """u (B,) -> (x in [0, 1), pdf, offset int64)."""
        off = find_interval(self.cdf, u)
        c0, c1 = _take(self.cdf, off), _take(self.cdf, off + 1)
        f = _take(self.func, off)
        du = u - c0
        denom = c1 - c0
        du = torch.where(denom > 0.0,
                         du / torch.where(denom > 0.0, denom, 1.0), du)
        pos, safe = self._safe_int()
        pdf = torch.where(pos, f / safe, 0.0)
        x = (off.float() + du) / self.count
        return x, pdf, off

    def sample_discrete(self, u):
        """u (B,) -> (offset int64, pmf, u remapped into the interval)."""
        off = find_interval(self.cdf, u)
        c0, c1 = _take(self.cdf, off), _take(self.cdf, off + 1)
        f = _take(self.func, off)
        pos, safe = self._safe_int()
        pdf = torch.where(pos, f / (safe * self.count), 0.0)
        denom = c1 - c0
        u_rm = torch.where(denom > 0.0,
                           (u - c0) / torch.where(denom > 0.0, denom, 1.0), u)
        return off, pdf, u_rm

    def discrete_pdf(self, index):
        pos, safe = self._safe_int()
        return torch.where(pos, _take(self.func, index) / (safe * self.count),
                           0.0)


@dataclasses.dataclass
class Distribution2D:
    """2D piecewise-constant distribution: ``conditional`` holds the (H, W)
    rows, ``marginal`` the (H,) row integrals."""
    conditional: Distribution1D
    marginal: Distribution1D

    def to(self, device) -> "Distribution2D":
        return Distribution2D(self.conditional.to(device),
                              self.marginal.to(device))

    @staticmethod
    def create(func, device="cpu") -> "Distribution2D":
        """func (H, W) non-negative."""
        cf, cc, ci = distribution_np(func)
        return Distribution2D(
            Distribution1D(*(torch.as_tensor(a, device=device)
                             for a in (cf, cc, ci))),
            Distribution1D.create(ci, device))

    def sample_continuous(self, u):
        """u (B, 2) -> ((B, 2) point in [0, 1)^2, pdf)."""
        d1, pdf1, v = self.marginal.sample_continuous(u[:, 1])
        c = self.conditional
        row = Distribution1D(c.func[v], c.cdf[v], c.func_int[v])
        d0, pdf0, _ = row.sample_continuous(u[:, 0])
        return torch.stack([d0, d1], dim=-1), pdf0 * pdf1

    def pdf(self, p):
        """Density at points p (B, 2) of [0, 1)^2."""
        h, w = self.conditional.func.shape
        iu = torch.clamp((p[:, 0] * w).int(), 0, w - 1).long()
        iv = torch.clamp((p[:, 1] * h).int(), 0, h - 1).long()
        f = self.conditional.func[iv, iu]
        total = self.marginal.func_int
        return torch.where(total > 0.0,
                           f / torch.where(total > 0.0, total, 1.0), 0.0)
