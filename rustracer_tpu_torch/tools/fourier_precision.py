"""How far K19's ways of summing the Fourier series lie from the plain
series, emulated in numpy on the CPU (no device number).

    python -m rustracer_tpu_torch.tools.fourier_precision [--lanes N]

For the luminance's coefficients of N seeded lanes (ops/fourier.py
_gather_ak) on a table of 64 orders (texture_work.fourier_table(64, 64))
and on two of about 1000 (``long_table``, the second glossier), prints
the largest absolute difference from the plain series
(core/interpolation.py fourier, float32) of: cos(k phi) by the float32
angle-addition recurrence summed in one float32 sum; the same summed in
float32 chunks of CHUNK orders added in double (csrc/fourier.cu's
series); and the exact series (float64), which says how far the plain
series itself lies from it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.interpolation import fourier
from ..ops import fourier as FO
from . import texture_work as TW

CHUNK = 32


def long_table(n_mu=8, m=1000, seed=3, r=(0.88, 0.92)):
    """A table of orders m - 6 to m on its reflection pairs (muI muO < 0),
    a_k = c |muI| r^k with r drawn from the range ``r``, R and B scaled:
    the dict of ``read_bsdf_table``."""
    rs = np.random.RandomState(seed)
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    a, off = [], np.zeros(n_mu * n_mu, np.int32)
    orders = np.zeros(n_mu * n_mu, np.int32)
    vals = np.zeros((n_mu, n_mu), np.float32)
    for oo in range(n_mu):
        for oi in range(n_mu):
            off[oo * n_mu + oi] = len(a)
            if mu[oi] * mu[oo] < 0.0:
                k = m - (oo + oi) % 7
                y = 0.25 / np.pi * abs(mu[oi]) \
                    * (r[0] + (r[1] - r[0]) * rs.rand()) ** np.arange(k)
                orders[oo * n_mu + oi] = k
                a += list(y) + list(1.05 * y) + list(0.9 * y)
                vals[oo, oi] = y[0]
    cdf, _ = FO.integrate_catmull_rom_np(mu, vals)
    return dict(mu=mu, cdf=cdf.astype(np.float32),
                a=np.asarray(a, np.float32), a_offset=off, m=orders,
                a0=vals, eta=1.0, m_max=int(orders.max()), n_channels=3)


def lanes_of(table, n, seed=7):
    """-> (a_k (n, m_pad) float32 of the luminance, cos phi (n,)) of n
    seeded direction pairs on ``table``."""
    ts = FO.make_table_set([table]).to("cpu")
    rs = np.random.RandomState(seed)

    def dirs():
        v = rs.normal(size=(n, 3))
        return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True))
                                .astype(np.float32))
    wo, wi = dirs(), dirs()
    tid = torch.zeros(n, dtype=torch.int32)
    mu_i, mu_o, cos_phi = FO._mu_angles(wo, wi)
    oi, wi_w, oo, wo_w, _ = FO._weights(ts, tid, mu_i, mu_o)
    ak = FO._gather_ak(ts, tid, oi, oo, wi_w, wo_w, channels=1)[:, 0]
    return ak.numpy(), cos_phi.numpy()


def recurrence(ak, cos_phi, chunk=None):
    """The series by the float32 recurrence from float32 cos phi and sin
    phi: one float32 sum, or float32 sums of ``chunk`` orders added in
    double."""
    phi = np.arccos(np.clip(cos_phi, -1.0, 1.0)).astype(np.float32)
    c1, s1 = np.cos(phi), np.sin(phi)
    ck, sk = np.ones_like(c1), np.zeros_like(s1)
    total = np.zeros(phi.shape, np.float64)
    part = np.zeros(phi.shape, np.float32)
    for k in range(ak.shape[1]):
        part = (part + ak[:, k] * ck).astype(np.float32)
        if chunk and (k + 1) % chunk == 0:
            total += part
            part[:] = 0.0
        ck, sk = ((ck * c1 - sk * s1).astype(np.float32),
                  (sk * c1 + ck * s1).astype(np.float32))
    return (total + part).astype(np.float32)


def report(lanes):
    """-> {table: {way: largest difference from the plain series}}."""
    out = {}
    for name, table in (("64 orders", TW.fourier_table(n_mu=64, m_max=64)),
                        ("1000 orders", long_table()),
                        ("1000 orders, r 0.97-0.99",
                         long_table(r=(0.97, 0.99)))):
        ak, cos_phi = lanes_of(table, lanes)
        plain = fourier(torch.from_numpy(ak),
                        torch.from_numpy(cos_phi)).numpy()
        phi = np.arccos(np.clip(cos_phi.astype(np.float64), -1.0, 1.0))
        exact = (ak.astype(np.float64)
                 * np.cos(phi[:, None] * np.arange(ak.shape[1]))).sum(-1)
        out[name] = {
            "one float32 sum": float(np.abs(recurrence(ak, cos_phi)
                                            - plain).max()),
            f"float32 chunks of {CHUNK} in double": float(np.abs(
                recurrence(ak, cos_phi, CHUNK) - plain).max()),
            "exact (float64)": float(np.abs(exact - plain).max())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4096)
    args = ap.parse_args(argv)
    for name, ways in report(args.lanes).items():
        print(f"{name}: " + "; ".join(f"{w} {e:.3g}" for w, e in ways.items())
              + " (largest difference from the plain series, CPU)")


if __name__ == "__main__":
    main()
