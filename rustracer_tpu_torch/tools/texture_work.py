"""The shading scenes and the inputs and bounds of their hand kernels: K17
(the per-texture mipmap lookups), K20 (their texel gradient), K18 (fbm and
turbulence) and K19 (the Fourier BSDF); shared by chip_smoke.py and the
tests.

- ``TEXTURE_SCENES``: three scenes on the testball layout (and
  textures-train, below)
  (``scenes/testball-matte.pbrt``'s camera, light and floor) that read only
  ``scenes/textures/grid.png``: ``textures-procedural`` (a marble ball
  bumped by a scaled wrinkled texture over a floor that mixes two
  checkerboards of textures, one a ``uv`` and one a ``windy``, by an
  ``fbm``), ``textures-image`` (a plastic ball with an imagemap at
  ``maxanisotropy`` 16 and a float imagemap bump, over a mix of a matte
  with a trilinear planar imagemap and a substrate with a clamped imagemap
  at ``maxanisotropy`` 4) and ``testball-fourier`` (a Fourier ball from a
  table ``write_fourier_table`` writes). ``scene_text`` formats one at a
  film size and sample count.
- ``fourier_table``: a seeded glossy table (3 channels, orders up to 8 or
  more, optionally a transmission lobe), not Lambertian.
- ``k17_work``, ``k18_work``, ``k19_work``: a call's bytes (each input read
  once, each output written once, each table entry or texel it needs read
  once) and operations, counted on its data; ``bound`` (chip_smoke.py)
  turns them into the least time on one H100.
- ``capture_texture_step``: every K17, K18 and K19 call of one renderer
  step; ``count_calls``: the calls of each entry point (mode) in a scope;
  ``count_bwd_calls``: K20's calls by mode in a scope, recorded on demand.
- ``TEXTURE_SCENES["textures-train"]``: a matte scene to train through
  the per-texture lookups (the Cornell box's walls of
  ``scenes/cornell-box.pbrt``: a planar imagemap floor (8-tap EWA), a
  trilinear back wall, a mix of a trilinear and an 8-tap imagemap by a
  trilinear float imagemap on the green wall, the exact EWA on the red
  wall, an atlas imagemap on the short block); ``k20_work`` and
  ``compare_bwd_with_plain``: K20's bytes and operations, and its check
  against its plain version.
- ``compare_with_plain``: a K17, K18 or K19 call's outputs against its
  plain version, with the tolerances and the flips it allows.

Operations are float32 or int32 operations at one each (a divide, a square
root, compares and selects included); expf, log2f, sinf, cosf and acosf at
the light tools' SIN_OPS.
"""
from __future__ import annotations

import contextlib
import inspect
import os

import numpy as np
import torch

from ..core.interpolation import catmull_rom_weights
from ..core.noise import octaves
from ..ops import mipmap as MM
from ..ops.fourier import integrate_catmull_rom_np, write_bsdf_table
from . import atlas_work
from .light_work import SCENES, SIN_OPS
from .quadric_work import record_calls

GRID = os.path.join(SCENES, "textures", "grid.png")

_STAGE = '''LookAt 0 1.7 -4.4   0 0.7 0   0 1 0
Camera "perspective" "float fov" [32]
Sampler "02sequence" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Integrator "path" "integer maxdepth" [7]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [11 11 11]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1.6 5.2 -1.6   1.6 5.2 -1.6   1.6 5.2 1.6   -1.6 5.2 1.6]
AttributeEnd
'''
_FLOOR = '''Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-8 0 -8   8 0 -8   8 0 8   -8 0 8]
  "float uv" [0 0  1 0  1 1  0 1]
'''
_BALL = '''AttributeBegin
  Translate 0 0.75 0
  {material}
  Shape "sphere" "float radius" [0.75]
AttributeEnd
WorldEnd
'''

TEXTURE_SCENES = {
    "textures-procedural": _STAGE + '''Texture "uvs" "spectrum" "uv" "float uscale" [16] "float vscale" [16]
Texture "wind" "spectrum" "windy"
Texture "checks1" "spectrum" "checkerboard"
  "float uscale" [16] "float vscale" [16]
  "texture tex1" "uvs" "rgb tex2" [0.75 0.75 0.75]
Texture "checks2" "spectrum" "checkerboard"
  "float uscale" [8] "float vscale" [8] "string aamode" "none"
  "texture tex1" "wind" "rgb tex2" [0.2 0.3 0.45]
Texture "amount" "float" "fbm" "integer octaves" [5] "float roughness" [0.6]
Texture "floor" "spectrum" "mix"
  "texture tex1" "checks1" "texture tex2" "checks2" "texture amount" "amount"
Material "matte" "texture Kd" "floor"
''' + _FLOOR + '''AttributeBegin
  Translate 0 0.75 0
  Texture "marble" "spectrum" "marble" "float scale" [3]
    "float variation" [0.8] "integer octaves" [6]
  Texture "wrinkles" "float" "wrinkled" "integer octaves" [6]
    "float roughness" [0.6]
  Texture "bump" "float" "scale" "texture tex1" "wrinkles" "float tex2" [0.02]
  Material "matte" "texture Kd" "marble" "texture bumpmap" "bump"
  Shape "sphere" "float radius" [0.75]
AttributeEnd
WorldEnd
''',
    "textures-image": _STAGE + '''Texture "planar" "spectrum" "imagemap" "string filename" "{grid}"
  "string mapping" "planar" "vector v1" [0.5 0 0] "vector v2" [0 0 0.5]
  "bool trilinear" "true"
Texture "clamped" "spectrum" "imagemap" "string filename" "{grid}"
  "string wrap" "clamp" "float maxanisotropy" [4]
  "float uscale" [1.5] "float vscale" [1.5] "float udelta" [-0.25]
MakeNamedMaterial "floor-matte" "string type" "matte" "texture Kd" "planar"
MakeNamedMaterial "floor-substrate" "string type" "substrate"
  "texture Kd" "clamped" "rgb Ks" [0.3 0.3 0.3] "float uroughness" [0.05]
  "float vroughness" [0.05]
Material "mix" "string namedmaterial1" "floor-matte"
  "string namedmaterial2" "floor-substrate" "rgb amount" [0.6 0.5 0.4]
''' + _FLOOR + _BALL.format(material='''Texture "ball" "spectrum" "imagemap" "string filename" "{grid}"
    "float maxanisotropy" [16] "float uscale" [4] "float vscale" [2]
  Texture "bumps" "float" "imagemap" "string filename" "{grid}"
    "float uscale" [8] "float vscale" [4] "float scale" [0.004]
  Material "plastic" "texture Kd" "ball" "texture bumpmap" "bumps"
    "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.05]'''),
    "testball-fourier": _STAGE + '''Texture "checks" "spectrum" "checkerboard"
  "float uscale" [16] "float vscale" [16]
  "rgb tex1" [0.2 0.2 0.2] "rgb tex2" [0.75 0.75 0.75]
Material "matte" "texture Kd" "checks"
''' + _FLOOR + _BALL.format(
        material='Material "fourier" "string bsdffile" "{bsdf}"'),
}
# the walls and blocks' top faces of scenes/cornell-box.pbrt
CORNELL_WALLS = {
    "floor": "552.8 0.0 0.0   0.0 0.0 0.0   0.0 0.0 559.2   549.6 0.0 559.2",
    "ceiling": "556.0 548.8 0.0   556.0 548.8 559.2   0.0 548.8 559.2   "
               "0.0 548.8 0.0",
    "back": "549.6 0.0 559.2   0.0 0.0 559.2   0.0 548.8 559.2   "
            "556.0 548.8 559.2",
    "green": "552.8 0.0 0.0   549.6 0.0 559.2   556.0 548.8 559.2   "
             "556.0 548.8 0.0",
    "red": "0.0 0.0 559.2   0.0 0.0 0.0   0.0 548.8 0.0   0.0 548.8 559.2",
    "short": "130.0 165.0 65.0   82.0 165.0 225.0   240.0 165.0 272.0   "
             "290.0 165.0 114.0",
    "tall": "423.0 330.0 247.0   265.0 330.0 296.0   314.0 330.0 456.0   "
            "472.0 330.0 406.0"}


def _quad(name):
    return ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            f'  "point P" [{CORNELL_WALLS[name]}]\n')


TEXTURE_SCENES["textures-train"] = (
    '''LookAt 278 273 -800   278 273 0   0 1 0
Camera "perspective" "float fov" [39.5]
Sampler "02sequence" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [18.4 15.6 8.0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [343.0 548.7 227.0   343.0 548.7 332.0
               213.0 548.7 332.0   213.0 548.7 227.0]
AttributeEnd
Texture "floor" "spectrum" "imagemap" "string filename" "{tiles}"
  "string mapping" "planar" "vector v1" [0.004 0 0] "vector v2" [0 0 0.004]
Material "matte" "texture Kd" "floor"
''' + _quad("floor") + '''Material "matte" "rgb Kd" [0.725 0.71 0.68]
''' + _quad("ceiling") + '''Texture "back" "spectrum" "imagemap" "string filename" "{tiles}"
  "bool trilinear" "true" "float uscale" [2] "float vscale" [2]
Material "matte" "texture Kd" "back"
''' + _quad("back") + '''Texture "wall-a" "spectrum" "imagemap" "string filename" "{tiles}"
  "float uscale" [3] "float vscale" [3] "bool trilinear" "true"
Texture "wall-b" "spectrum" "imagemap" "string filename" "{tiles}"
  "float udelta" [0.5] "string wrap" "clamp"
Texture "amount" "float" "imagemap" "string filename" "{amount}"
  "float uscale" [2] "float vscale" [2] "bool trilinear" "true"
Texture "green" "spectrum" "mix" "texture tex1" "wall-a"
  "texture tex2" "wall-b" "texture amount" "amount"
Material "matte" "texture Kd" "green"
''' + _quad("green") + '''Texture "red" "spectrum" "imagemap" "string filename" "{tiles}"
  "float maxanisotropy" [16] "float uscale" [1.5] "string wrap" "black"
Material "matte" "texture Kd" "red"
''' + _quad("red") + '''Texture "block" "spectrum" "imagemap" "string filename" "{grid}"
  "float uscale" [2] "float vscale" [2]
Material "matte" "texture Kd" "block"
''' + _quad("short") + '''Material "matte" "rgb Kd" [0.725 0.71 0.68]
''' + _quad("tall") + "WorldEnd\n")
# the Fourier ball's table (fourier_table's defaults)
FOURIER_FILE = "ball.bsdf"
# textures-train's images: a seeded size^2 colour tiling of the walls and
# floor, and a seeded grey amount map of 3/4 x 5/8 of it (resampled to
# size^2 by the pyramid build). The default 32^2 (6 levels) keeps the JAX
# package's gradient of the scene (every level of every lookup, in the
# CPU parity test) quick to compile; a train step on the card takes
# 1024^2 (11 levels, 1.4 M texels an image), an imagemap's real size
TILES_FILE, AMOUNT_FILE = "tiles.exr", "amount.exr"


def write_train_images(out_dir, size=32):
    """Write textures-train's two images, at ``size`` (a multiple of 8),
    as EXRs into ``out_dir`` (the readers give the grey map 3 equal
    channels; the float texture takes the first) -> (tiles path, amount
    path)."""
    from ..render.imageio import write_exr
    rs = np.random.RandomState(17)
    yy, xx = np.mgrid[0:size, 0:size]
    tiles = np.stack([0.5 + 0.4 * np.sin(xx / 2.5), 0.5 + 0.4 * np.cos(
        yy / 3.5), 0.3 + 0.5 * rs.rand(size, size)], -1)
    ah, aw = size * 3 // 4, size * 5 // 8
    yy, xx = np.mgrid[0:ah, 0:aw]
    v = 0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0) \
        + 0.2 * rs.rand(ah, aw)
    paths = (os.path.join(out_dir, TILES_FILE),
             os.path.join(out_dir, AMOUNT_FILE))
    write_exr(paths[0], np.clip(tiles, 0, 1).astype(np.float32))
    write_exr(paths[1], np.repeat(np.clip(v, 0, 1)[..., None], 3,
                                  -1).astype(np.float32))
    return paths


def scene_text(name, res=64, spp=16, bsdf_dir=None, image_size=32) -> str:
    """``TEXTURE_SCENES[name]`` with its film at res^2 and ``spp``
    samples; testball-fourier writes its table, textures-train its
    images (at ``image_size``, write_train_images) into the directory
    ``bsdf_dir``."""
    bsdf = tiles = amount = ""
    if name == "testball-fourier":
        bsdf = os.path.join(bsdf_dir, FOURIER_FILE)
        write_fourier_table(bsdf)
    if name == "textures-train":
        tiles, amount = write_train_images(bsdf_dir, image_size)
    return TEXTURE_SCENES[name].format(res=res, spp=spp, grid=GRID,
                                       bsdf=bsdf, tiles=tiles, amount=amount)


def plastic_cornell_text(res=16) -> str:
    """scenes/cornell-box.pbrt at res^2 with the short block's white matte
    made plastic (roughness 0.1): a glossy lobe whose sampled bounce
    directions depend on a trained leaf, so a train step over it reaches
    the refusal of ROADMAP item B12."""
    with open(os.path.join(SCENES, "cornell-box.pbrt")) as f:
        text = f.read()
    white = 'Material "matte" "rgb Kd" [0.725 0.71 0.68]'
    head, block, rest = text.split(white, 2)
    text = head + white + block + white.replace(
        '"matte"', '"plastic"') + ' "float roughness" [0.1]' + rest
    return text.replace('"integer xresolution" [64] "integer yresolution" '
                        '[64]', f'"integer xresolution" [{res}] '
                        f'"integer yresolution" [{res}]')


def fourier_table(n_mu=16, m_max=8, seed=5, transmission=0.0, eta=1.0):
    """A seeded glossy table: on the reflection pairs (muI muO < 0) the
    luminance's orders a_k = c |muI| r^k (a truncated Poisson kernel, the
    glossier the closer the pair lies to the mirror direction), orders
    m = 1 + (oo + oi) % m_max (so up to m_max), R and B tinted per order;
    with ``transmission`` > 0 a 2-order lobe on the pairs of equal signs.
    -> the dict of ``read_bsdf_table``."""
    rs = np.random.RandomState(seed)
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    tint_r = 1.0 + 0.1 * rs.rand(m_max)
    tint_b = 0.8 + 0.1 * rs.rand(m_max)
    a, a_offset = [], np.zeros(n_mu * n_mu, np.int32)
    m = np.zeros(n_mu * n_mu, np.int32)
    vals_y = np.zeros((n_mu, n_mu), np.float32)
    for oo in range(n_mu):
        for oi in range(n_mu):
            pair = oo * n_mu + oi
            mui, muo = float(mu[oi]), float(mu[oo])
            a_offset[pair] = len(a)
            if mui * muo < 0.0:
                k = 1 + (oo + oi) % m_max
                r = 0.3 + 0.6 * max(0.0, 1.0 - abs(abs(mui) - abs(muo)))
                y = 0.25 / np.pi * abs(mui) * r ** np.arange(k)
            elif transmission > 0.0 and mui * muo > 0.0:
                k = 2
                y = transmission / np.pi * abs(mui) * np.array([1.0, 0.5])
            else:
                continue
            m[pair] = k
            a += list(y) + list(y * tint_r[:k]) + list(y * tint_b[:k])
            vals_y[oo, oi] = y[0]
    cdf, _ = integrate_catmull_rom_np(mu, vals_y)
    return dict(mu=mu, cdf=cdf.astype(np.float32),
                a=np.asarray(a, np.float32), a_offset=a_offset, m=m,
                a0=vals_y, eta=float(eta), m_max=int(m.max()), n_channels=3)


def write_fourier_table(path, **kw):
    """Write ``fourier_table(**kw)`` as a .bsdf file at ``path``."""
    t = fourier_table(**kw)
    write_bsdf_table(path, t["mu"], t["a"], t["a_offset"], t["m"], t["cdf"],
                     eta=t["eta"], n_channels=t["n_channels"])
    return path


# --- K17 ---

# a bilinear lookup's weights, its texel coordinates and the blend of its
# four texels' three channels; a trilinear lookup's level (log2f and the
# clamps) and its blend of two bilinear lookups
BILERP_OPS = 10 + 6 + 21
LEVEL_OPS = SIN_OPS + 6
BLEND_OPS = 2 * BILERP_OPS + 9
TRILINEAR_OPS = LEVEL_OPS + BLEND_OPS
# the 8-tap lookup's axes (two lengths with their square roots, the
# selects, the clamp), its one level (the taps share the minor axis), its
# taps (the position, two bilinear lookups blended, the weighted sum) and
# the final divide
EWA_OPS = 16 + LEVEL_OPS + 8 * (4 + BLEND_OPS + 6) + 3
# the exact lookup's set-up (axes, clamp, level, the ellipse's coefficients
# and box; about 70), a visited tap (its texel, r^2: 12), a tap inside
# (expf, the weight, three weighted channels and the sum: SIN_OPS + 8)
EXACT_SETUP_OPS = 70 + SIN_OPS
EXACT_TAP_OPS = 12
EXACT_IN_OPS = SIN_OPS + 8
TEXEL_BYTES = 12


def _texel_index(off, w, h, wrap, s, t):
    """The texel indices of ops/mipmap.py _texel_rows (-1 where
    WRAP_BLACK reads none)."""
    idx, read = atlas_work._texel_index(off, w, h, torch.tensor(wrap), s, t)
    return torch.where(read, idx, -1)


def _corners(tx, li, st, wrap, into):
    off, w, h, s0, t0, _, _ = MM.bilerp_corner(tx, li, st)
    for ds, dt in ((0, 0), (1, 0), (0, 1), (1, 1)):
        into.append(_texel_index(off, w, h, wrap, s0 + ds, t0 + dt))


def k17_work(tx, mode, wrap, st, dst0=None, dst1=None, width=None,
             max_anisotropy=8.0) -> dict:
    """-> dict(lanes, texels (distinct texels read), taps (exact: box taps
    visited), inside (exact: taps inside the ellipse), moved, ops) of one
    K17 call in ``mode`` (ops/mipmap.py TRILINEAR, EWA, EWA_EXACT) on these
    inputs: each lane's st and differentials (or width) read and its (3,)
    result written, each distinct texel its lookups read (12 B)."""
    n = st.shape[0]
    idx, taps, inside, fallback = [], 0, 0, 0
    if mode == MM.TRILINEAR:
        l0, l1, _ = MM.tri_levels(tx, width)
        for li in (l0, l1):
            _corners(tx, li, st, wrap, idx)
        ops = n * TRILINEAR_OPS
        lane_in = 12
    elif mode == MM.EWA:
        major, minor_len = MM.ewa_axes(dst0, dst1, max_anisotropy)
        l0, l1, _ = MM.tri_levels(tx, minor_len)
        for a, _ in MM.TAPS:
            for li in (l0, l1):
                _corners(tx, li, st + a * major, wrap, idx)
        ops = n * EWA_OPS
        lane_in = 24
    else:
        e = MM.ellipse(tx, st, dst0, dst1, max_anisotropy)
        any_in = torch.zeros(n, dtype=torch.bool, device=st.device)
        for k in range(MM.N_TAPS_EXACT):
            ss, tt, ok, _ = MM.ellipse_tap(e, k)
            taps += int((k < e.n_box).sum())
            inside += int(ok.sum())
            any_in |= ok
            idx.append(torch.where(ok, _texel_index(e.off, e.w, e.h, wrap,
                                                    ss, tt), -1))
        none = ~any_in
        fallback = int(none.sum())
        if fallback:
            _corners(tx, e.li[none], st[none], wrap, idx)
        ops = n * EXACT_SETUP_OPS + taps * EXACT_TAP_OPS \
            + inside * EXACT_IN_OPS
        lane_in = 24
    flat = torch.unique(torch.cat([i.reshape(-1) for i in idx]))
    texels = int((flat >= 0).sum())
    return dict(lanes=n, texels=texels, taps=taps, inside=inside,
                fallback=fallback,
                moved=n * (lane_in + 12) + texels * TEXEL_BYTES, ops=ops)


def k20_work(g, tx, mode, wrap, st, dst0=None, dst1=None, width=None,
             max_anisotropy=8.0) -> dict:
    """-> dict(lanes, active (the lanes that add: k20_active), texels
    (distinct texel rows they add into), adds (their texel adds that reach
    a texel: k20_adds), moved, ops) of one K20 call, the backward of the
    K17 call of these inputs. Bytes: every lane's gradient (12 B) and
    coordinates (st and width or differentials) read once, to find the
    lanes that add, and each distinct texel row an active lane adds into
    written once (12 B, the (T, 3) rows). Operations of the active lanes
    only: the forward's set-up and weights (k17_work) and 3 a texel add
    (the scaled gradient's channels); a lane whose gradient is 0 adds
    exactly 0, which changes no bit."""
    act = k20_active(g, mode, st, dst0, dst1)

    def some(x):
        return None if x is None else x[act]
    sub = (st[act], some(dst0), some(dst1), some(width), max_anisotropy)
    w = k17_work(tx, mode, wrap, *sub)
    keys, _ = k20_adds(torch.ones_like(g[act]), tx, mode, wrap, *sub)
    adds = int((keys >= 0).sum())
    n = st.shape[0]
    lane_in = 12 if mode == MM.TRILINEAR else 24
    moved = n * (lane_in + 12) + w["texels"] * TEXEL_BYTES
    return dict(lanes=n, active=int(act.sum()), texels=w["texels"],
                adds=adds, moved=moved, ops=w["ops"] + 3 * adds)


def k20_adds(g, tx, mode, wrap, st, dst0=None, dst1=None, width=None,
             max_anisotropy=8.0):
    """The texel adds of one K20 call, in the order a lane of the design
    with one thread a lane makes them -> (keys (B, A) int64, the texel or
    -1 where WRAP_BLACK reads none or the add is masked, vals (B, A, 3)):
    trilinear 2 levels x 4 corners (A = 8); the 8-tap lookup tap k, level
    l, corner c at (k * 2 + l) * 4 + c (A = 64); the exact lookup its 128
    box taps (those inside the ellipse, where the lane's weight sum is
    above 1e-9), then the bilinear fallback's 4 corners (A = 132)."""
    keys, vals = [], []

    def quad(li, at, scale):
        off, w, h, s0, t0, ds, dt = MM.bilerp_corner(tx, li, at)
        ds, dt = ds.reshape(-1), dt.reshape(-1)
        for c, wc in enumerate(((1 - ds) * (1 - dt), ds * (1 - dt),
                                (1 - ds) * dt, ds * dt)):
            keys.append(_texel_index(off, w, h, wrap, s0 + (c & 1),
                                     t0 + (c >> 1)))
            vals.append(scale * wc[:, None])
    if mode == MM.TRILINEAR:
        l0, l1, dl = MM.tri_levels(tx, width)
        quad(l0, st, g * (1.0 - dl))
        quad(l1, st, g * dl)
    elif mode == MM.EWA:
        major, minor_len = MM.ewa_axes(dst0, dst1, max_anisotropy)
        l0, l1, dl = MM.tri_levels(tx, minor_len)
        gw = g / MM.WSUM32
        for (a, _), wk in zip(MM.TAPS, MM.TAP_WEIGHTS32):
            quad(l0, st + a * major, gw * wk * (1.0 - dl))
            quad(l1, st + a * major, gw * wk * dl)
    else:
        e = MM.ellipse(tx, st, dst0, dst1, max_anisotropy)
        taps = [MM.ellipse_tap(e, k) for k in range(MM.N_TAPS_EXACT)]
        wgt = [torch.where(ok, torch.exp(-2.0 * r2) - MM._E2, 0.0)
               for _, _, ok, r2 in taps]
        wsum = sum(wgt)
        inside = wsum > 1e-9
        gd = g / torch.clamp(wsum, min=1e-9)[:, None]
        for (ss, tt, ok, _), w in zip(taps, wgt):
            keys.append(torch.where(ok & inside, _texel_index(
                e.off, e.w, e.h, wrap, ss, tt), -1))
            vals.append(gd * w[:, None])
        quad(e.li, st, torch.where(inside[:, None], 0.0, g))
        for c in range(4):
            keys[-4 + c] = torch.where(inside, -1, keys[-4 + c])
    return torch.stack(keys, 1).long(), torch.stack(vals, 1)


def _nonzero_sums(ids, vals):
    """The channel sums of ``vals`` (N, 3) grouped by ``ids`` that are
    not 0: the atomics of adds that leave out an add of exactly 0."""
    if not ids.numel():
        return 0
    u, inv = torch.unique(ids, return_inverse=True)
    sums = torch.zeros((u.numel(), 3), dtype=vals.dtype, device=vals.device)
    sums.index_add_(0, inv, vals)
    return int((sums != 0).sum())


def k20_active(g, mode, st, dst0=None, dst1=None):
    """(B,) bool: the lanes of a K20 call that add (csrc/mipmap_bwd.cu
    adds): a nonzero gradient, or a coordinate (st, and the differentials
    in the EWA modes) that is not finite."""
    coords = [st] if mode == MM.TRILINEAR else [st, dst0, dst1]
    finite = torch.stack([torch.isfinite(c).all(1) for c in coords]).all(0)
    return (g != 0).any(1) | ~finite


# K20's tiles (csrc/mipmap_bwd.cu: 256 lanes) and the 8-tap lookup's
# fewest threads a lookup (kEwaLeastGroup)
K20_TILE = 256
K20_EWA_LEAST = 4


def _merged(keys, vals):
    """A quad's corners (keys (4, N), vals (4, N, 3)) with the corners that
    reach one texel summed into the first of them (its key the others'
    -1), as texel_grad.cuh add_quad sums them."""
    keys, vals = keys.clone(), vals.clone()
    for c in range(1, 4):
        for d in range(c):
            same = (keys[c] >= 0) & (keys[c] == keys[d])
            vals[d] += torch.where(same[:, None], vals[c], 0.0)
            vals[c] = torch.where(same[:, None], 0.0, vals[c])
            keys[c] = torch.where(same, -1, keys[c])
    return keys, vals


def _k20_new(g, tx, mode, wrap, st, dst0, dst1, width, max_anisotropy):
    """The global atomics of this K20 (csrc/mipmap_bwd.cu) on these
    inputs, replayed: the lanes that add packed a tile, G threads a lookup
    by the tile's count; the 8-tap lookup as K10's (atlas_work: two open
    quads a thread), trilinear a quad a level (both at one call site where
    G is 2), the exact lookup a call site a box tap and its fallback's quad,
    each summed over the warp's lanes with the same texel at one call site,
    one add a channel of a nonzero sum."""
    act = k20_active(g, mode, st, dst0, dst1)
    lanes = torch.nonzero(act).flatten()
    if not lanes.numel():
        return 0
    tile = K20_TILE
    sub = [None if x is None else x[lanes] for x in (g, st, dst0, dst1,
                                                     width)]
    gs, sts, d0, d1, ws = sub
    n_texels = tx.texels.shape[0]
    if mode == MM.EWA:
        major, minor_len = MM.ewa_axes(d0, d1, max_anisotropy)
        l0, l1, dl = MM.tri_levels(tx, minor_len)
        dl = dl[:, 0]
        out = {k: [[None] * 8 for _ in range(2)]
               for k in ("s0", "t0", "ds", "dt", "f")}
        lv = []
        for li, (lev, lw) in enumerate(((l0, 1.0 - dl), (l1, dl))):
            for k, (a, _) in enumerate(MM.TAPS):
                off, w, h, s0, t0, ds, dt = MM.bilerp_corner(
                    tx, lev, sts + a * major)
                for name, v in (("s0", s0), ("t0", t0), ("ds", ds[:, 0]),
                                ("dt", dt[:, 0]),
                                ("f", MM.TAP_WEIGHTS32[k] * lw)):
                    out[name][li][k] = v
            lv.append((off, w, h))
        tp = {k: torch.stack([torch.stack(v, -1) for v in out[k]], 1)
              for k in out}
        tp.update(lanes=lanes, dl=dl,
                  wrap=torch.full_like(lanes, int(wrap)),
                  **{k: torch.stack([x[i] for x in lv], 1)
                     for i, k in enumerate(("off", "w", "h"))})
        scale = torch.full((lanes.numel(),), 1.0 / MM.WSUM32,
                           device=lanes.device)
        return atlas_work._k10_new(tp, g, scale, n_texels, tile,
                                   K20_EWA_LEAST)
    ids, vals = [], []

    def add(site, keys, v):          # site (N,) or a number, keys (N,)
        ok = keys >= 0
        site = torch.broadcast_to(torch.as_tensor(site, device=keys.device),
                                  keys.shape)
        ids.append((warp[ok] * 1024 + site[ok]) * n_texels + keys[ok])
        vals.append(v[ok])

    def quad(site, li, at, scale):   # scale (N, 3)
        off, w, h, s0, t0, ds, dt = MM.bilerp_corner(tx, li, at)
        ds, dt = ds[:, 0], dt[:, 0]
        keys = torch.stack([_texel_index(off, w, h, wrap, s0 + (c & 1),
                                         t0 + (c >> 1)) for c in range(4)])
        wc = torch.stack([(1 - ds) * (1 - dt), ds * (1 - dt),
                          (1 - ds) * dt, ds * dt])
        keys, v = _merged(keys, wc[:, :, None] * scale[None])
        for c in range(4):
            add(site * 4 + c, keys[c], v[c])
    if mode == MM.TRILINEAR:
        grp, warp = atlas_work.packed_warps(lanes, tile, 2)
        l0, l1, dl = MM.tri_levels(tx, ws)
        quad(0, l0, sts, gs * (1.0 - dl))
        # one thread a lookup adds level 1 at a call site of its own; two
        # add it beside level 0's, from the lookup's second thread
        quad(torch.where(grp == 1, 1, 0), l1, sts, gs * dl)
    else:
        # G threads a lookup, each every G-th box tap: tap k at its
        # thread's call site k // G
        grp, warp = atlas_work.packed_warps(lanes, tile, 8)
        e = MM.ellipse(tx, sts, d0, d1, max_anisotropy)
        wgt = []
        for k in range(MM.N_TAPS_EXACT):
            ss, tt, ok, r2 = MM.ellipse_tap(e, k)
            wgt.append((ss, tt, ok, torch.where(ok, torch.exp(-2.0 * r2)
                                                - MM._E2, 0.0)))
        wsum = sum(w for *_, w in wgt)
        inside = wsum > 1e-9
        gd = gs / torch.clamp(wsum, min=1e-9)[:, None]
        for k, (ss, tt, ok, w) in enumerate(wgt):
            add(4 * (k // grp),
                torch.where(ok & inside, _texel_index(
                    e.off, e.w, e.h, wrap, ss, tt), -1), gd * w[:, None])
        quad(torch.full_like(lanes, 200), e.li, sts,
             torch.where(inside[:, None], 0.0, gs))
    return _nonzero_sums(torch.cat(ids), torch.cat(vals))


def k20_atomics(g, tx, mode, wrap, st, dst0=None, dst1=None, width=None,
                max_anisotropy=8.0) -> dict:
    """The global atomics of one K20 call, counted from its inputs ->
    dict of:

    - adds: the texel adds of all lanes (k20_adds: those that reach a
      texel);
    - parent: the design with one thread a lane (32 consecutive lanes a
      warp), whose lanes of a warp that add into one texel at one add
      number (the warp's trip, for the exact mode's taps) sum first, one
      atomic a channel of a nonzero sum;
    - new: this design's (_k20_new);
    - max_adds_texel: the most adds that land on one texel."""
    keys, vals = k20_adds(g, tx, mode, wrap, st, dst0, dst1, width,
                          max_anisotropy)
    n, a = keys.shape
    ok = keys >= 0
    if not bool(ok.any()):
        return dict(adds=0, parent=0, new=0, max_adds_texel=0)
    warp = (torch.arange(n, device=keys.device) // 32)[:, None].expand(n, a)
    site = torch.arange(a, device=keys.device)[None, :].expand(n, a)
    n_texels = tx.texels.shape[0]
    ids = (warp[ok] * a + site[ok]) * n_texels + keys[ok]
    return dict(adds=int(ok.sum()), parent=_nonzero_sums(ids, vals[ok]),
                new=_k20_new(g, tx, mode, wrap, st, dst0, dst1, width,
                             max_anisotropy),
                max_adds_texel=int(torch.bincount(keys[ok]).max()))


# --- K18 ---

# noise3: the floor and fraction (9), three quintic fades (18), eight
# corners' hash of 3 words (3 rounds of a 7-operation mix with its xor and
# add, and the final mix: 34) and gradient (10), seven lerps (21); an
# octave adds the point's scaling (3) and its weighted sum (3)
NOISE3_OPS = 9 + 18 + 8 * (34 + 10) + 21
OCTAVE_OPS = NOISE3_OPS + 6
# the footprint's octave count: two squared lengths, log2f, the clamp
K18_SETUP_OPS = 12 + SIN_OPS + 4


def k18_work(dpdx, dpdy, max_octaves) -> dict:
    """-> dict(lanes, octaves (the noise3 evaluations: each lane's full
    octaves and its partial one), moved, ops) of one K18 call: each lane's
    p, dpdx, dpdy read (36 B) and its value written (4 B)."""
    _, n_int = octaves(dpdx, dpdy, max_octaves)
    n = dpdx.shape[0]
    evals = int(n_int.sum().item()) + n
    return dict(lanes=n, octaves=evals, moved=n * 40,
                ops=n * K18_SETUP_OPS + evals * OCTAVE_OPS)


# --- K19 ---

# a channel's series term: its a_k summed over the 16 neighbours (a
# compare, a load's address and a multiply-add each: 4) and the cosine
# (SIN_OPS) with its product and sum
K19_TERM_OPS = 16 * 4 + SIN_OPS + 3
# the angles (muI, muO, cos phi: 16), two Catmull-Rom weight sets (the
# knots' compares N each, then about 40), the neighbours' 16 runs (6 each),
# acosf, the RGB (12)
K19_LANE_OPS = 16 + 2 * 40 + 16 * 6 + SIN_OPS + 12
# sample_f: the 2D spline's bisection and interpolations (4 rows, 3
# operations each, some 20 of them) and its 30 Newton steps (25 each);
# the direction (30 with sinf, cosf)
K19_SAMPLE_OPS = 20 * 12 + 30 * 25 + 30 + 2 * SIN_OPS
# sample_fourier on the luminance: its a_k summed once over the 16
# neighbours (K19_AK_OPS a term), then 30 + 1 evaluations of F and f, a
# term each a sine and a cosine with their products and sums (K19_FF_OPS)
K19_AK_OPS = 16 * 4
K19_FF_OPS = 2 * SIN_OPS + 6
# the recurrence design (csrc/fourier.cu), counted in instructions as
# PEAK_OPS_PER_S rates them (the kernel's explicit fmaf is one fused
# instruction, the rest -fmad=false): an order's cosine and sine from those
# of the order below by the angle-addition recurrence (2 multiplies, 2
# fused multiply-adds: K19_REC_OPS), shared by the channels, from one
# sincosf an evaluation (SIN_OPS); a channel's term its a_k summed over the
# 16 neighbours and one fused multiply-add (K19_REC_TERM_OPS); a term of
# sample_fourier's F and f the recurrence, the sine's coefficient times
# 1/k and its fused multiply-add (2), the cosine's fused multiply-add (1)
K19_REC_OPS = 4
K19_REC_TERM_OPS = K19_AK_OPS + 1
K19_REC_FF_OPS = K19_REC_OPS + 2 + 1


def _runs(ts, tid, mu_i, mu_o):
    """The lanes' neighbour runs: -> (valid (B,), runs (B, 16) int64 index
    of (table, pair), orders (B, 16) with 0 where the weight is 0)."""
    t = tid.long()
    mu_t = ts.mu[t]
    oi, wi_w, ok_i = catmull_rom_weights(mu_t, mu_i)
    oo, wo_w, ok_o = catmull_rom_weights(mu_t, mu_o)
    n = ts.n_mu
    runs, orders = [], []
    for b in range(4):
        row = torch.clamp(oo + b, 0, n - 1)
        for a in range(4):
            col = torch.clamp(oi + a, 0, n - 1)
            pair = (row * n + col).long()
            w = wi_w[:, a] * wo_w[:, b]
            runs.append(t * n * n + pair)
            orders.append(torch.where(w != 0.0, ts.m[t, pair], 0))
    return ok_i & ok_o, torch.stack(runs, 1), torch.stack(orders, 1)


def k19_work(ts, mode, tid, wo, second, mask) -> dict:
    """-> dict(lanes, active (masked-in lanes with valid weights), orders
    (the series' orders summed over lanes), terms (over channels too),
    moved, ops, ops_direct) of one K19 call in ``mode`` (ops/fourier.py F,
    PDF, SAMPLE_F) on these inputs: each lane's tid, wo, wi or u and mask
    read and its outputs written; each active lane's table knots (4 N B,
    once a table) and each distinct neighbour run's coefficients (channels
    x order x 4 B) read once. ``ops`` counts the series by the recurrence
    (K19_REC_*: one sincosf an evaluation), ``ops_direct`` with a sine or
    cosine a term (K19_TERM_OPS, K19_FF_OPS: the per-term design's
    count). For sample_f the runs are those of the sampled direction's muI
    (the plain version's)."""
    from ..ops import fourier as FO
    n = tid.shape[0]
    on = torch.ones(n, dtype=torch.bool, device=tid.device) \
        if mask is None else mask
    t = torch.clamp(tid.long(), 0, ts.mu.shape[0] - 1)
    if mode == FO.SAMPLE_F:
        wi, _, _ = FO.sample_f_plain(ts, t.int(), wo, second)
        mu_i = -wi[:, 2]
    else:
        mu_i = -second[:, 2]
    ok, runs, orders = _runs(ts, t.int(), mu_i, wo[:, 2])
    act = ok & on
    channels = 1 if mode == FO.PDF else 3
    kmax = orders.max(1).values.clamp(max=ts.m_pad)
    terms = int(kmax[act].sum()) * channels
    r, o = runs[act].reshape(-1), orders[act].reshape(-1)
    keep = o > 0
    uniq, inv = torch.unique(r[keep], return_inverse=True)
    run_m = torch.zeros(uniq.shape[0], dtype=o.dtype, device=o.device)
    run_m.scatter_reduce_(0, inv, o[keep], "amax")
    tables = int(torch.unique(t[act]).numel())
    lane_io = {FO.F: 4 + 12 + 12 + 1 + 12, FO.PDF: 4 + 12 + 12 + 1 + 4,
               FO.SAMPLE_F: 4 + 12 + 8 + 1 + 12 + 12 + 4}[mode]
    moved = n * lane_io + tables * 4 * ts.n_mu \
        + int(run_m.sum()) * channels * 4
    n_act = int(act.sum())
    orders = int(kmax[act].sum())
    ops_direct = n_act * K19_LANE_OPS + terms * K19_TERM_OPS
    ops = n_act * (K19_LANE_OPS + SIN_OPS) + terms * K19_REC_TERM_OPS \
        + orders * K19_REC_OPS
    if mode == FO.SAMPLE_F:
        sample = int(on.sum()) * K19_SAMPLE_OPS + orders * K19_AK_OPS
        ops_direct += sample + orders * 31 * K19_FF_OPS
        ops += sample + 31 * (orders * K19_REC_FF_OPS + n_act * SIN_OPS)
    return dict(lanes=n, active=n_act, orders=orders, terms=terms,
                moved=moved, ops=ops, ops_direct=ops_direct)


# --- K17-K19 against their plain versions ---

# the tolerances, absolute, on every lane held: the trilinear and 8-tap
# lookups and the noise 1e-5 (a level's floor may flip at an integer lod,
# but the blend of the two levels is continuous there), the exact lookup
# 2e-5 (expf near the ellipse's edge); the Fourier f and pdf 1e-5 of the
# largest magnitude plus 1e-6, a sampled direction 1e-4
TOLERANCE = {"lookup_trilinear": 1e-5, "lookup_ewa": 1e-5,
             "lookup_ewa_exact": 2e-5, "fbm": 1e-5, "turbulence": 1e-5}
DIRECTION_TOL = 1e-4
# discrete choices that a last-bit difference can flip: the exact lookup's
# rounded level (its lod within NEAR_FLIP of a half-integer), the noise's
# octave count (within NEAR_FLIP of an integer) and a sampled Fourier
# direction (its bisections' and Newton steps' compares). At most
# FLIP_SHARE of a call's lanes may flip; each is held to the plain version
# at the other choice: the neighbouring level, the octave count on the
# other side, the plain f at the kernel's own direction (within FLIP_F_TOL
# of the largest magnitude plus 1e-6: mu_i and cos phi recomputed from the
# normalized vector) with a unit direction and a finite pdf >= 0
NEAR_FLIP = 1e-4
FLIP_SHARE = 1e-4
FLIP_F_TOL = 1e-3
# the footprint scale that moves the octave count by 1e-3 across a flip
_OCTAVE_NUDGE = float(np.float32(2.0 ** 1e-3))


def _entry(fname):
    from ..core import noise
    from ..ops import fourier
    if fname in ("fbm", "turbulence"):
        return getattr(noise, fname)
    return getattr(fourier if fname.startswith("fourier") else MM, fname)


def _plain(fname, *args):
    from .. import cuda
    with cuda.plain_reference():
        return _entry(fname)(*args)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _off(a, b, tol):
    return ((a - b).abs() > tol).reshape(a.shape[0], -1).any(-1)


def _near_flip(fname, a, offs):
    """The lanes whose discrete choice a last-bit difference can flip."""
    if fname == "lookup_ewa_exact":
        _, _, lod = MM.exact_lod(a["tx"], a["dst0"], a["dst1"],
                                 a["max_anisotropy"])
        return (lod - torch.floor(lod) - 0.5).abs() < NEAR_FLIP
    if fname in ("fbm", "turbulence"):
        n, _ = octaves(a["dpdx"], a["dpdy"], a["max_octaves"])
        return (n - torch.round(n)).abs() < NEAR_FLIP
    if fname == "fourier_sample_f":
        return offs[0]
    return torch.zeros_like(offs[0])


def _flip_held(fname, a, outs, refs, tols, i):
    """-> (k,) bool: the flipped lanes ``i`` agree with the plain version
    at the other choice."""
    if fname == "lookup_ewa_exact":
        tx, meta = a["tx"], a["tx"].meta
        ok = torch.zeros(i.shape[0], dtype=torch.bool, device=i.device)
        for shifted in (torch.cat([meta[1:], meta[-1:]]),
                        torch.cat([meta[:1], meta[:-1]])):
            alt = _plain(fname, MM.Texels(tx.texels, shifted, tx.channels),
                         a["st"][i], a["dst0"][i], a["dst1"][i],
                         a["max_anisotropy"], a["wrap"])
            ok |= ~_off(outs[0][i], alt, tols[0])
        return ok
    if fname in ("fbm", "turbulence"):
        ok = torch.zeros(i.shape[0], dtype=torch.bool, device=i.device)
        for s in (_OCTAVE_NUDGE, 1.0 / _OCTAVE_NUDGE):
            alt = _plain(fname, a["p"][i], a["dpdx"][i] * s,
                         a["dpdy"][i] * s, a["omega"], a["max_octaves"])
            ok |= ~_off(outs[0][i], alt, tols[0])
        return ok
    wi, f, pdf = (o[i] for o in outs)
    mask = None if a["mask"] is None else a["mask"][i]
    f_at = _plain("fourier_f", a["ts"], a["tid"][i], a["wo"][i], wi, mask)
    tol = FLIP_F_TOL * max(refs[1].abs().max().item(), 1.0) + 1e-6
    unit = ((wi * wi).sum(-1).sqrt() - 1.0).abs() < 1e-5
    return unit & ~_off(f, f_at, tol) & torch.isfinite(pdf) & (pdf >= 0.0)


def compare_with_plain(fname, args, out) -> dict:
    """The outputs ``out`` of one call of K17-K19's entry point ``fname``
    (``lookup_trilinear``, ``lookup_ewa``, ``lookup_ewa_exact``, ``fbm``,
    ``turbulence``, ``fourier_f``, ``fourier_pdf``, ``fourier_sample_f``)
    on ``args`` against its plain version on the same inputs: every lane
    within TOLERANCE, but for at most FLIP_SHARE of the lanes whose
    discrete choice flipped, each held to the plain version at the other
    choice. Raises AssertionError otherwise. -> dict(lanes, flipped,
    max_abs_err (over the lanes held to the tolerance))."""
    a = inspect.signature(_entry(fname)).bind(*args)
    a.apply_defaults()
    a = dict(a.arguments)
    outs, refs = _tuple(out), _tuple(_plain(fname, *args))
    n = outs[0].shape[0]
    if fname.startswith("fourier"):
        tols = [1e-5 * max(b.abs().max().item() if b.numel() else 0.0, 1.0)
                + 1e-6 for b in refs]
        if fname == "fourier_sample_f":
            tols[0] = DIRECTION_TOL
    else:
        tols = [TOLERANCE[fname]]
    offs = [_off(o, r, t) for o, r, t in zip(outs, refs, tols)]
    off = torch.stack(offs).any(0)
    near = _near_flip(fname, a, offs)
    bad = int((off & ~near).sum())
    if bad:
        raise AssertionError(f"{fname}: {bad} of {n} lanes beyond {tols} "
                             "where no choice can flip")
    flipped = off & near
    n_flip = int(flipped.sum())
    if n_flip > FLIP_SHARE * n:
        raise AssertionError(f"{fname}: {n_flip} of {n} lanes flipped, "
                             f"more than {FLIP_SHARE} of them")
    if n_flip:
        i = flipped.nonzero()[:, 0]
        held = int(_flip_held(fname, a, outs, refs, tols, i).sum())
        if held < n_flip:
            raise AssertionError(f"{fname}: {n_flip - held} flipped lanes "
                                 "differ from the plain version at the "
                                 "other choice")
    err = 0.0
    for o, r in zip(outs, refs):
        d = (o - r).abs().reshape(n, -1)[~flipped]
        err = max(err, d.max().item() if d.numel() else 0.0)
    return dict(lanes=n, flipped=n_flip, max_abs_err=err)


# K20 against its plain version: each texel's gradient within BWD_TOL of
# the largest sum of its terms' magnitudes (the plain backward of |g|; the
# lanes' adds land in another order)
BWD_TOL = 1e-5


def compare_bwd_with_plain(g, tx, mode, wrap, st, dst0, dst1, width,
                           max_anisotropy, out) -> dict:
    """K20's texel gradient ``out`` for the lookups' gradient ``g`` of one
    K17 call (``mode``, ``wrap``, its coordinates) against its plain
    version on the same inputs: every entry within BWD_TOL of the largest
    sum of magnitudes. Where a call of the exact mode disagrees, its lanes
    whose rounded level a last-bit difference can flip (within NEAR_FLIP
    of a half-integer), at most FLIP_SHARE of them, are held apart: both
    sides are taken again without their gradient, and must agree. Raises
    AssertionError otherwise. -> dict(lanes, flipped, max_abs_err,
    scale)."""
    from .. import cuda
    args = (tx, mode, wrap, st, dst0, dst1, width, max_anisotropy)
    with cuda.plain_reference():
        ref = MM.mipmap_lookup_bwd(g, *args)
        scale = MM.mipmap_lookup_bwd(g.abs(), *args).max().item()
    err = (out - ref).abs().max().item()
    n, flipped = g.shape[0], 0
    if not err <= BWD_TOL * scale and mode == MM.EWA_EXACT:
        _, _, lod = MM.exact_lod(tx, dst0, dst1, max_anisotropy)
        near = (lod - torch.floor(lod) - 0.5).abs() < NEAR_FLIP
        flipped = int(near.sum())
        if flipped > FLIP_SHARE * n:
            raise AssertionError(f"K20: {flipped} of {n} lanes near a level "
                                 f"flip, more than {FLIP_SHARE} of them")
        g = torch.where(near[:, None], 0.0, g)
        out = MM.mipmap_lookup_bwd(g, *args)
        with cuda.plain_reference():
            ref = MM.mipmap_lookup_bwd(g, *args)
        err = (out - ref).abs().max().item()
    if not err <= BWD_TOL * scale or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K20 (mode {mode}, wrap {wrap}): max abs err "
                             f"{err:.3g} beyond {BWD_TOL} of {scale:.3g}")
    return dict(lanes=n, flipped=flipped, max_abs_err=err, scale=scale)


# --- capture ---

# K17-K19's entry points, as scene/textures.py (K17, K18) and ops/bsdf.py
# (K19, from ops/fourier.py) call them
TEXTURE_CALLS = ("lookup_trilinear", "lookup_ewa", "lookup_ewa_exact",
                 "fbm", "turbulence")
FOURIER_CALLS = ("fourier_f", "fourier_pdf", "fourier_sample_f")


def _lanes(name, args):
    return args[0 if name in ("fbm", "turbulence") else 1].shape[0]


@contextlib.contextmanager
def count_calls(into):
    """Within the scope, ``into[name]`` counts the calls of each entry
    point of TEXTURE_CALLS and FOURIER_CALLS on at least one lane: on CUDA
    tensors each launches its kernel once, in that mode."""
    from ..ops import fourier
    from ..scene import textures
    saved = []

    def counted(name, orig):
        def call(*args):
            if _lanes(name, args):
                into[name] = into.get(name, 0) + 1
            return orig(*args)
        return call
    for module, names in ((textures, TEXTURE_CALLS),
                          (fourier, FOURIER_CALLS)):
        for name in names:
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, counted(name, saved[-1][2]))
    try:
        yield into
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


# K20's modes by name, as chip_smoke's rows and count_bwd_calls name them
BWD_MODES = {MM.TRILINEAR: "trilinear", MM.EWA: "ewa", MM.EWA_EXACT: "exact"}


@contextlib.contextmanager
def count_bwd_calls(into, record=None):
    """Within the scope, ``into[mode name]`` counts the calls of
    ops/mipmap.py ``mipmap_lookup_bwd`` (K20 on CUDA tensors, one launch a
    call) on at least one lane, by BWD_MODES name; with ``record`` (a
    dict), ``record[mode name]`` lists each call's arguments (g, tx, mode,
    wrap, st, dst0, dst1, width, max_anisotropy). autograd's backward
    calls it through the module, in whatever thread it runs."""
    orig = MM.mipmap_lookup_bwd

    def counted(g, tx, mode, *rest):
        if g.shape[0]:
            name = BWD_MODES[mode]
            into[name] = into.get(name, 0) + 1
            if record is not None:
                record.setdefault(name, []).append((g, tx, mode) + rest)
        return orig(g, tx, mode, *rest)
    MM.mipmap_lookup_bwd = counted
    try:
        yield into
    finally:
        MM.mipmap_lookup_bwd = orig


def capture_texture_step(renderer, ctx, tile, sample=1) -> dict:
    """One step of ``tile`` at ``sample`` -> the arguments of every call,
    in order, of the per-texture lookups (``lookup_trilinear``,
    ``lookup_ewa``, ``lookup_ewa_exact``: K17), of ``fbm`` and
    ``turbulence`` (K18) as scene/textures.py calls them, and of
    ops/fourier.py ``fourier_f``, ``fourier_pdf`` and ``fourier_sample_f``
    (K19), under those names."""
    from ..ops import fourier
    from ..scene import textures
    calls = {}
    px, py, v = tile
    fs = renderer.film.init_state(renderer.device)
    with contextlib.ExitStack() as stack:
        for name in TEXTURE_CALLS:
            stack.enter_context(record_calls(textures, name, calls, True))
        for name in FOURIER_CALLS:
            stack.enter_context(record_calls(fourier, name, calls, True))
        renderer.step(ctx, fs, px, py, sample, v)
    return calls
