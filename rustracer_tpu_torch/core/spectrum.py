"""RGB helpers (port of rustracer_tpu/core/spectrum.py: luminance, is_black,
and the host-side numpy conversions the scene parser reaches: sRGB decode,
XYZ to RGB, sampled spectra and blackbody emitters, copied as they are so
both packages parse a file into the same values)."""
from __future__ import annotations

import numpy as np
import torch

# luminance weights: the Y row of the sRGB -> XYZ matrix, float32
LUM_WEIGHTS = tuple(float(w) for w in np.array(
    [0.212671, 0.715160, 0.072169], np.float32))


def luminance(rgb):
    w0, w1, w2 = LUM_WEIGHTS
    return rgb[..., 0] * w0 + rgb[..., 1] * w1 + rgb[..., 2] * w2


def is_black(rgb):
    return torch.all(rgb == 0.0, dim=-1)


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_cmf(lam):
    """Analytic CIE 1931 2-deg color matching functions at wavelength lam
    (nm): the multi-lobe Gaussian fits of Wyman, Sloan and Shirley (2013)."""
    lam = np.asarray(lam, dtype=np.float64)
    x = (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
         + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss(lam, 0.821, 568.8, 46.9, 40.5)
         + _gauss(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss(lam, 1.217, 437.0, 11.8, 36.0)
         + _gauss(lam, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


def from_sampled(lams, vals):
    """SPD samples -> linear RGB (numpy (3,)): the SPD integrated against
    the CMFs over [360, 830] nm, samples interpolated piecewise linearly."""
    lams = np.asarray(lams, dtype=np.float64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.argsort(lams)
    lams, vals = lams[order], vals[order]
    grid = np.arange(360.0, 831.0, 1.0)
    v = np.interp(grid, lams, vals)
    xb, yb, zb = cie_xyz_cmf(grid)
    scale = 1.0 / np.trapezoid(yb, grid)
    X = np.trapezoid(v * xb, grid) * scale
    Y = np.trapezoid(v * yb, grid) * scale
    Z = np.trapezoid(v * zb, grid) * scale
    return xyz_to_rgb_np(np.array([X, Y, Z]))


def blackbody_rgb(temperature_k, normalize=True):
    """Planck blackbody SPD -> RGB, optionally normalized to peak 1."""
    grid = np.arange(360.0, 831.0, 1.0)
    lam_m = grid * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    le = (2.0 * h * c * c) / (lam_m ** 5 * (np.exp(
        h * c / (lam_m * kb * float(temperature_k))) - 1.0))
    if normalize:
        le = le / le.max()
    return from_sampled(grid, le)


# sRGB (D65) XYZ -> RGB matrix
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], dtype=np.float32)


def xyz_to_rgb_np(xyz):
    return (_XYZ_TO_RGB.astype(np.float64)
            @ np.asarray(xyz, np.float64)).astype(np.float32)


def srgb_decode_np(encoded):
    """sRGB gamma -> linear, float32 numpy."""
    encoded = np.asarray(encoded, np.float32)
    return np.where(encoded <= 0.04045,
                    encoded / 12.92,
                    ((encoded + 0.055) / 1.055) ** 2.4).astype(np.float32)


# Named metal spectra (eta, k) for the metal material: sampled SPDs
# (Palik / CRC handbooks) on a coarse wavelength grid, converted to RGB at
# scene build (the reference material/metal.rs's default is copper)
_CU_LAMS = [360, 400, 440, 480, 520, 560, 600, 640, 680, 720, 760, 830]
_CU_ETA = [1.38, 1.25, 1.18, 1.15, 1.12, 1.05, 0.43, 0.26, 0.24, 0.23, 0.23, 0.24]
_CU_K = [1.72, 2.04, 2.21, 2.36, 2.49, 2.60, 3.21, 3.67, 4.05, 4.35, 4.62, 4.95]
_AU_LAMS = [360, 400, 440, 480, 520, 560, 600, 640, 680, 720, 760, 830]
_AU_ETA = [1.68, 1.66, 1.54, 1.36, 0.83, 0.43, 0.25, 0.20, 0.17, 0.16, 0.16, 0.17]
_AU_K = [1.94, 1.96, 1.85, 1.80, 2.12, 2.46, 2.92, 3.37, 3.81, 4.22, 4.60, 5.26]
_AG_LAMS = [360, 400, 440, 480, 520, 560, 600, 640, 680, 720, 760, 830]
_AG_ETA = [0.19, 0.17, 0.15, 0.14, 0.13, 0.12, 0.12, 0.13, 0.14, 0.15, 0.15, 0.16]
_AG_K = [1.64, 2.00, 2.36, 2.70, 3.01, 3.31, 3.66, 3.96, 4.26, 4.56, 4.86, 5.36]


def metal_eta_k(name="Cu"):
    """-> (eta, k) RGB (numpy (3,)) of a named metal; copper for an
    unknown name."""
    tables = {
        "Cu": (_CU_LAMS, _CU_ETA, _CU_K),
        "Au": (_AU_LAMS, _AU_ETA, _AU_K),
        "Ag": (_AG_LAMS, _AG_ETA, _AG_K),
    }
    lams, eta, k = tables.get(name, tables["Cu"])
    return from_sampled(lams, eta), from_sampled(lams, k)
