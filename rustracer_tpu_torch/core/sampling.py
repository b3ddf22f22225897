"""Monte-Carlo warps (port of rustracer_tpu/core/sampling.py, the subset the
render path uses)."""
from __future__ import annotations

import numpy as np
import torch

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
