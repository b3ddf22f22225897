"""The Fourier BSDF: measured layered materials in a Catmull-Rom x Fourier
basis (port of rustracer_tpu/ops/fourier.py) and its hand kernel K19
(csrc/fourier.cu).

The .bsdf reader and writer, the Lambertian test table and the stacking of
a scene's tables are the reference's numpy code, copied. A table set keeps
each table's ragged coefficient runs in one flat array: the run of the
(muO, muI) pair p = oo * N + oi holds m[p] orders of its channels [Y, R,
B] at a_flat[a_offset[p] + c * m[p] + k]. Tables of a scene are padded to
one N and stacked along a leading table axis; a lane names its table.

``fourier_f``, ``fourier_pdf`` and ``fourier_sample_f`` route by device:
CPU tensors take the plain versions (the reference's arithmetic: the 4 x
4 Catmull-Rom neighbours' runs summed into (B, 3, m_pad) coefficients,
then the series), CUDA tensors launch K19, one thread a lane, which sums
its neighbours' runs once (in registers where the table set's m_pad is
at most 8) and evaluates the series by the angle-addition recurrence. A ``mask`` (B,) restricts the work to its lanes (the others
give zeros), so a lobe stack pays only on its FOURIER rows.
"""
from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda
from ..core.interpolation import (catmull_rom_weights, fourier,
                                  integrate_catmull_rom_np,
                                  sample_catmull_rom_2d, sample_fourier)

PI = math.pi
_2PI32 = float(np.float32(2.0 * PI))
# K19's modes
F, PDF, SAMPLE_F = 0, 1, 2


class FourierTableSet(NamedTuple):
    """Stacked .bsdf tables (leading axis T, the number of tables)."""
    mu: object        # (T, N) float32, the zenith cosine knots
    a_flat: object    # (T, NC) float32, the ragged coefficient runs
    a_offset: object  # (T, N * N) int32, each pair's run
    m: object         # (T, N * N) int32, each pair's order
    a0: object        # (T, N, N) float32, the luminance's k = 0 terms
    cdf: object       # (T, N, N) float32
    eta: object       # (T,) float32
    n_channels: object  # (T,) int32, 1 or 3
    m_pad: int        # the largest order of any table (at least 1)

    @property
    def n_mu(self):
        return self.mu.shape[-1]

    def to(self, device) -> "FourierTableSet":
        """The set as tensors on ``device``."""
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x, dtype=dtype, device=device)
        f32, i32 = torch.float32, torch.int32
        return FourierTableSet(
            t(self.mu, f32), t(self.a_flat, f32), t(self.a_offset, i32),
            t(self.m, i32), t(self.a0, f32), t(self.cdf, f32),
            t(self.eta, f32), t(self.n_channels, i32), int(self.m_pad))


def read_bsdf_table(path: str) -> dict:
    """Parse a .bsdf file -> numpy dict."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header != b"SCATFUN\x01":
            raise ValueError(f"BSDF file {path!r} has an invalid header")
        ints = struct.unpack("<9I", f.read(36))
        (flags, n_mu, n_coeffs, m_max, n_channels, n_bases,
         _n_meta, _n_params, _n_param_values) = ints
        eta, _a0, _a1, _u0, _u1 = struct.unpack("<5f", f.read(20))
        if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
            raise ValueError(f"Unsupported BSDF file {path!r}")
        mu = np.frombuffer(f.read(4 * n_mu), "<f4")
        cdf = np.frombuffer(f.read(4 * n_mu * n_mu), "<f4")
        off_len = np.frombuffer(f.read(8 * n_mu * n_mu), "<u4")
        a = np.frombuffer(f.read(4 * n_coeffs), "<f4")
    a_offset = off_len[0::2].astype(np.int32)
    m = off_len[1::2].astype(np.int32)
    a0 = np.where(m > 0, a[np.minimum(a_offset, len(a) - 1)], 0.0)
    return dict(mu=mu.copy(), cdf=cdf.reshape(n_mu, n_mu).copy(),
                a=a.copy(), a_offset=a_offset, m=m,
                a0=a0.reshape(n_mu, n_mu).astype(np.float32),
                eta=float(eta), m_max=int(m_max),
                n_channels=int(n_channels))


def write_bsdf_table(path: str, mu, a, a_offset, m, cdf, eta=1.0,
                     n_channels=3):
    """Write a .bsdf file in the reference's format."""
    mu = np.asarray(mu, np.float32)
    a = np.asarray(a, np.float32)
    a_offset = np.asarray(a_offset, np.uint32)
    m = np.asarray(m, np.uint32)
    cdf = np.asarray(cdf, np.float32).reshape(-1)
    n_mu = mu.size
    m_max = int(m.max()) if m.size else 0
    off_len = np.empty(2 * n_mu * n_mu, np.uint32)
    off_len[0::2] = a_offset
    off_len[1::2] = m
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9I", 1, n_mu, a.size, m_max, n_channels, 1,
                            0, 0, 0))
        f.write(struct.pack("<5f", eta, 0.0, 0.0, 0.0, 0.0))
        f.write(mu.astype("<f4").tobytes())
        f.write(cdf.astype("<f4").tobytes())
        f.write(off_len.astype("<u4").tobytes())
        f.write(a.astype("<f4").tobytes())


def make_lambertian_table(kd=(0.5, 0.5, 0.5), n_mu=16):
    """A table of f = kd / pi: only k = 0 is nonzero, with a0_Y(muI, muO)
    = Y(kd) / pi * |muI| on the pairs of opposite raw signs (reflection),
    the stored coefficients absorbing the 1 / |muI| of the evaluation."""
    kd = np.asarray(kd, np.float32)
    y = 0.212671 * kd[0] + 0.715160 * kd[1] + 0.072169 * kd[2]
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    n = n_mu
    a = []
    a_offset = np.zeros(n * n, np.int32)
    m = np.zeros(n * n, np.int32)
    vals_y = np.zeros((n, n), np.float32)
    for oo in range(n):
        for oi in range(n):
            pair = oo * n + oi
            mui, muo = mu[oi], mu[oo]
            a_offset[pair] = len(a)
            if mui * muo < 0.0:
                ay = y / PI * abs(mui)
                m[pair] = 1
                a += [ay, kd[0] / PI * abs(mui), kd[2] / PI * abs(mui)]
                vals_y[oo, oi] = ay
    cdf, _ = integrate_catmull_rom_np(mu, vals_y)
    return dict(mu=mu, cdf=cdf.astype(np.float32),
                a=np.asarray(a, np.float32),
                a_offset=a_offset, m=m, a0=vals_y, eta=1.0, m_max=1,
                n_channels=3)


def make_table_set(tables) -> FourierTableSet:
    """Pad and stack table dicts into one set of numpy arrays (None for no
    table). Knots are padded past the last in steps of 1e-3; padded cdf
    columns keep the row's maximum, padded rows repeat the last real row."""
    if not tables:
        return None
    n = max(t["mu"].size for t in tables)
    nc = max(t["a"].size for t in tables)
    m_pad = max(max(1, t["m_max"]) for t in tables)
    n_t = len(tables)

    def pad_mu(mu):
        out = np.full(n, mu[-1] + 1e-3, np.float32)
        out[:mu.size] = mu
        for i in range(mu.size, n):
            out[i] = out[i - 1] + 1e-3
        return out

    mu = np.stack([pad_mu(t["mu"]) for t in tables])
    a_flat = np.zeros((n_t, nc), np.float32)
    a_offset = np.zeros((n_t, n * n), np.int32)
    m = np.zeros((n_t, n * n), np.int32)
    a0 = np.zeros((n_t, n, n), np.float32)
    cdf = np.zeros((n_t, n, n), np.float32)
    eta = np.ones(n_t, np.float32)
    nch = np.ones(n_t, np.int32)
    for ti, t in enumerate(tables):
        sz = t["mu"].size
        a_flat[ti, :t["a"].size] = t["a"]
        a_offset[ti].reshape(n, n)[:sz, :sz] = t["a_offset"].reshape(sz, sz)
        m[ti].reshape(n, n)[:sz, :sz] = t["m"].reshape(sz, sz)
        a0[ti, :sz, :sz] = t["a0"]
        cdf[ti, :sz, :sz] = t["cdf"]
        if sz < n:
            cdf[ti, :sz, sz:] = t["cdf"][:, -1:]
            cdf[ti, sz:, :sz] = t["cdf"][-1:, :]
            cdf[ti, sz:, sz:] = t["cdf"][-1, -1]
        eta[ti] = t["eta"]
        nch[ti] = t["n_channels"]
    return FourierTableSet(mu=mu, a_flat=a_flat, a_offset=a_offset, m=m,
                           a0=a0, cdf=cdf, eta=eta, n_channels=nch,
                           m_pad=int(m_pad))


# --- plain versions (the reference's arithmetic) ---

def _gather_ak(ts: FourierTableSet, tid, oi, oo, wi_w, wo_w, channels=3):
    """The 4 x 4 neighbours' weighted coefficient runs summed -> ak (B,
    channels, m_pad), channels [Y, R, B] as stored."""
    n = ts.n_mu
    k = torch.arange(ts.m_pad, dtype=torch.int32, device=tid.device)
    c = torch.arange(channels, dtype=torch.int32, device=tid.device)
    ak = torch.zeros(tid.shape + (channels, ts.m_pad), dtype=torch.float32,
                     device=tid.device)
    t = tid.long()
    nc_flat = ts.a_flat.shape[-1]
    for b in range(4):
        row = torch.clamp(oo + b, 0, n - 1)
        for a_i in range(4):
            col = torch.clamp(oi + a_i, 0, n - 1)
            w = wi_w[:, a_i] * wo_w[:, b]
            pair = (row * n + col).long()
            off = ts.a_offset[t, pair]
            mm = ts.m[t, pair]
            idx = off[:, None, None] + c[:, None] * mm[:, None, None] + k
            ok = (k < mm[:, None, None]) & (w != 0.0)[:, None, None]
            idx = torch.clamp(idx, 0, nc_flat - 1)
            vals = ts.a_flat[t[:, None, None], idx.long()]
            ak = ak + torch.where(ok, w[:, None, None] * vals, 0.0)
    return ak


def _mu_angles(wo, wi):
    """-> (muI, muO, cos phi) in the shading frame."""
    mu_i = -wi[:, 2]
    mu_o = wo[:, 2]
    num = (-wi[:, 0]) * wo[:, 0] + (-wi[:, 1]) * wo[:, 1]
    den = torch.sqrt((wi[:, 0] * wi[:, 0] + wi[:, 1] * wi[:, 1])
                     * (wo[:, 0] * wo[:, 0] + wo[:, 1] * wo[:, 1]))
    cos_phi = torch.clamp(num / torch.clamp(den, min=1e-20), -1.0, 1.0)
    return mu_i, mu_o, torch.where(den < 1e-20, 1.0, cos_phi)


def _rgb_from_ak(ak, cos_phi, mu_i, mu_o, eta, n_channels):
    """The series of each channel at cos phi, RGB from [Y, R, B] (G
    reconstructed), scaled by 1 / |muI| and, for transmission, eta^2."""
    y = torch.clamp(fourier(ak[:, 0], cos_phi), min=0.0)
    scale = torch.where(torch.abs(mu_i) > 1e-20, 1.0 / torch.abs(mu_i), 0.0)
    e = torch.where(mu_i > 0.0, 1.0 / eta, eta)
    scale = scale * torch.where(mu_i * mu_o > 0.0, e * e, 1.0)
    r = fourier(ak[:, 1], cos_phi)
    b = fourier(ak[:, 2], cos_phi)
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    rgb = torch.clamp(torch.stack([r, g, b], -1), min=0.0) * scale[:, None]
    mono = (y * scale)[:, None].expand(-1, 3)
    return torch.where((n_channels == 1)[:, None], mono, rgb)


def _weights(ts, tid, mu_i, mu_o):
    mu_t = ts.mu[tid.long()]
    oi, wi_w, ok_i = catmull_rom_weights(mu_t, mu_i)
    oo, wo_w, ok_o = catmull_rom_weights(mu_t, mu_o)
    return oi, wi_w, oo, wo_w, ok_i & ok_o


def f_plain(ts: FourierTableSet, tid, wo, wi):
    """Plain version of K19's f: FourierBSDF::f -> (B, 3)."""
    mu_i, mu_o, cos_phi = _mu_angles(wo, wi)
    oi, wi_w, oo, wo_w, ok = _weights(ts, tid, mu_i, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w)
    t = tid.long()
    f = _rgb_from_ak(ak, cos_phi, mu_i, mu_o, ts.eta[t], ts.n_channels[t])
    return torch.where(ok[:, None], f, 0.0)


def pdf_plain(ts: FourierTableSet, tid, wo, wi):
    """Plain version of K19's pdf: the luminance's series over its total
    2 pi times the interpolated cdf's last column -> (B,)."""
    mu_i, mu_o, cos_phi = _mu_angles(wo, wi)
    oi, wi_w, oo, wo_w, ok = _weights(ts, tid, mu_i, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w, channels=1)
    n = ts.n_mu
    t = tid.long()
    rho = torch.zeros_like(mu_o)
    for b in range(4):
        row = torch.clamp(oo + b, 0, n - 1).long()
        rho = rho + wo_w[:, b] * ts.cdf[t, row, n - 1] * _2PI32
    y = fourier(ak[:, 0], cos_phi)
    pdf = torch.where((rho > 0) & (y > 0), y / torch.clamp(rho, min=1e-20),
                      0.0)
    return torch.where(ok, pdf, 0.0)


def sample_f_plain(ts: FourierTableSet, tid, wo, u):
    """Plain version of K19's sample_f: muI from the 2D spline of a0 given
    muO, phi from the luminance's series. -> (wi (B, 3), f (B, 3), pdf
    (B,))."""
    mu_o = wo[:, 2]
    t = tid.long()
    mu_t = ts.mu[t]
    mu_i, _, pdf_mu = sample_catmull_rom_2d(mu_t, mu_t, ts.a0, ts.cdf, mu_o,
                                            u[:, 1], rows=t)
    oi, wi_w, oo, wo_w, ok = _weights(ts, tid, mu_i, mu_o)
    ak = _gather_ak(ts, tid, oi, oo, wi_w, wo_w)
    _, pdf_phi, phi = sample_fourier(ak[:, 0], u[:, 0])
    pdf = torch.clamp(pdf_phi * pdf_mu, min=0.0)
    sin2_i = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
    sin2_o = wo[:, 0] * wo[:, 0] + wo[:, 1] * wo[:, 1]
    norm = torch.sqrt(sin2_i / torch.clamp(sin2_o, min=1e-20))
    norm = torch.where(torch.isfinite(norm) & (sin2_o > 1e-20), norm, 0.0)
    sp, cp = torch.sin(phi), torch.cos(phi)
    wi = -torch.stack([norm * (cp * wo[:, 0] - sp * wo[:, 1]),
                       norm * (sp * wo[:, 0] + cp * wo[:, 1]), mu_i], -1)
    wi = wi / torch.clamp(torch.sqrt((wi * wi).sum(-1, keepdim=True)),
                          min=1e-20)
    f = _rgb_from_ak(ak, torch.clamp(cp, -1.0, 1.0), mu_i, mu_o, ts.eta[t],
                     ts.n_channels[t])
    return (torch.where(ok[:, None], wi, 0.0),
            torch.where(ok[:, None], f, 0.0), torch.where(ok, pdf, 0.0))


# --- the routed entry points ---

def _prep(ts, tid, mask):
    """tid clamped to the table set (a masked lane's is arbitrary)."""
    tid = torch.clamp(tid.int(), 0, ts.mu.shape[0] - 1)
    if mask is not None:
        tid = torch.where(mask, tid, 0)
    return tid


def _k19(mode, ts: FourierTableSet, tid, wo, second, mask, lib=None):
    """K19 in ``mode`` -> (f, pdf, wi), None where the mode has no such
    output; ``lib`` another build of the kernel (cuda.launch)."""
    n = tid.shape[0]
    dev = tid.device
    t_n, n_mu = ts.mu.shape
    for name, x, dtype, shape in (
            ("mu", ts.mu, torch.float32, (t_n, n_mu)),
            ("a_flat", ts.a_flat, torch.float32, (t_n, ts.a_flat.shape[1])),
            ("a_offset", ts.a_offset, torch.int32, (t_n, n_mu * n_mu)),
            ("m", ts.m, torch.int32, (t_n, n_mu * n_mu)),
            ("a0", ts.a0, torch.float32, (t_n, n_mu, n_mu)),
            ("cdf", ts.cdf, torch.float32, (t_n, n_mu, n_mu)),
            ("eta", ts.eta, torch.float32, (t_n,)),
            ("n_channels", ts.n_channels, torch.int32, (t_n,))):
        cuda.check(x, name, dtype, shape, dev)
    tid, wo, second = (x.contiguous() for x in (tid, wo, second))
    cuda.check(tid, "tid", torch.int32, (n,), dev)
    cuda.check(wo, "wo", torch.float32, (n, 3), dev)
    cuda.check(second, "u" if mode == SAMPLE_F else "wi", torch.float32,
               (n, 2 if mode == SAMPLE_F else 3), dev)
    if mask is not None:
        mask = mask.contiguous()
        cuda.check(mask, "mask", torch.bool, (n,), dev)
    f = torch.empty((n, 3), dtype=torch.float32, device=dev) \
        if mode != PDF else None
    pdf = torch.empty(n, dtype=torch.float32, device=dev) \
        if mode != F else None
    wi = torch.empty((n, 3), dtype=torch.float32, device=dev) \
        if mode == SAMPLE_F else None
    if n:
        cuda.launch("fourier_bsdf", mode, ts.mu, ts.a_flat, ts.a_offset, ts.m,
                    ts.a0, ts.cdf, ts.eta, ts.n_channels, n_mu,
                    ts.a_flat.shape[1], ts.m_pad, tid, wo, second, mask, n,
                    f, pdf, wi, lib=lib)
    return f, pdf, wi


def fourier_f(ts: FourierTableSet, tid, wo, wi, mask=None):
    """FourierBSDF::f of table ``tid`` (B,) at shading-frame wo, wi (B, 3)
    -> (B, 3); zeros off ``mask``. CPU tensors take the plain version,
    CUDA tensors launch K19."""
    tid = _prep(ts, tid, mask)
    if not cuda.use_kernel(tid):
        f = f_plain(ts, tid, wo, wi)
        return f if mask is None else torch.where(mask[:, None], f, 0.0)
    return _k19(F, ts, tid, wo, wi, mask)[0]


def fourier_pdf(ts: FourierTableSet, tid, wo, wi, mask=None):
    """FourierBSDF::pdf -> (B,); zeros off ``mask``. CPU tensors take the
    plain version, CUDA tensors launch K19."""
    tid = _prep(ts, tid, mask)
    if not cuda.use_kernel(tid):
        pdf = pdf_plain(ts, tid, wo, wi)
        return pdf if mask is None else torch.where(mask, pdf, 0.0)
    return _k19(PDF, ts, tid, wo, wi, mask)[1]


def fourier_sample_f(ts: FourierTableSet, tid, wo, u, mask=None):
    """FourierBSDF::sample_f of wo (B, 3) with u (B, 2) -> (wi (B, 3), f
    (B, 3), pdf (B,)); zeros off ``mask``. CPU tensors take the plain
    version, CUDA tensors launch K19."""
    tid = _prep(ts, tid, mask)
    if not cuda.use_kernel(tid):
        out = sample_f_plain(ts, tid, wo, u)
        if mask is None:
            return out
        wi, f, pdf = out
        return (torch.where(mask[:, None], wi, 0.0),
                torch.where(mask[:, None], f, 0.0),
                torch.where(mask, pdf, 0.0))
    f, pdf, wi = _k19(SAMPLE_F, ts, tid, wo, u, mask)
    return wi, f, pdf
