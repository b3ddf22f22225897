"""Port parity of the scene front end's host modules: the lexer, parser,
paramset, PLY and image I/O of ``rustracer_tpu_torch`` against the JAX
package's.

- Every ``scenes/*.pbrt``: the port's token stream and the stream of api
  calls its parser makes (directive, arguments, every parameter's type and
  values) equal the JAX package's, and the ParamSet lookups give equal
  values (spectra through the copied numpy helpers, bit for bit).
- PLY: binary and ascii round trips give the same arrays in both
  packages.
- EXR: the port's writer gives the JAX writer's bytes; both readers give
  the same pixels. PFM and HDR likewise.
- PNG and TGA: the port decodes and encodes them itself; the JAX package
  goes through PIL. Held in decoded pixels: files PIL writes here (gray,
  gray-alpha, RGB, RGBA, palette; PIL's encoder uses row filters 0, 1, 2
  and 4), one file per row filter written by this test's encoder (filter 3,
  Average, which PIL never picks, among them), uncompressed and RLE TGA;
  and the port's PNG and TGA writers read back by PIL.
"""
import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rustracer_tpu.render import imageio as JI
from rustracer_tpu.scene import lexer as JL
from rustracer_tpu.scene import parser as JP
from rustracer_tpu.utils import plyio as JPLY
from rustracer_tpu_torch.core import spectrum as PS
from rustracer_tpu_torch.render import imageio as PI
from rustracer_tpu_torch.scene import lexer as PL
from rustracer_tpu_torch.scene import parser as PP
from rustracer_tpu_torch.utils import plyio as PPLY

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(glob.glob(os.path.join(REPO, "scenes", "*.pbrt")))


class _Recorder:
    """An api that records every call the parser makes, with each
    ParamSet flattened to its (name, type, values) entries."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, tuple(_flat(a) for a in args)))
        return record


def _flat(a):
    if hasattr(a, "_items"):
        return tuple(sorted((k, ty, tuple(map(repr, v)))
                            for k, (ty, v) in a._items.items()))
    if isinstance(a, (list, tuple)):
        return tuple(_flat(x) for x in a)
    return repr(a)


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_token_and_directive_streams_equal(path):
    jt, pt = JL.tokenize_file(path), PL.tokenize_file(path)
    assert [tuple(t) for t in pt] == [tuple(t) for t in jt]
    jr, pr = _Recorder(), _Recorder()
    JP.parse(jt, jr, include_dir=os.path.dirname(path))
    PP.parse(pt, pr, include_dir=os.path.dirname(path))
    assert pr.calls == jr.calls
    assert any(c[0] == "world_end" for c in pr.calls)


PARAMS = '''Shape "x" "float a" [1.5 2] "integer n" [3] "bool b" "true"
  "string s" "hello" "rgb c" [0.1 0.2 0.3] "xyz x" [0.3 0.4 0.5]
  "blackbody t" [5500 2] "spectrum sp" [400 1 500 2 600 3 700 1]
  "point P" [0 1 2 3 4 5] "normal N" [0 0 1] "point2 uv" [0 1 1 0]
  "texture k" "tex"
'''


def test_paramset_lookups_equal():
    jps = JP._parse_params(JP._Stream(JL.tokenize(PARAMS)[2:]))
    pps = PP._parse_params(PP._Stream(PL.tokenize(PARAMS)[2:]))
    for name, default in (("c", (1, 1, 1)), ("x", (1, 1, 1)),
                          ("t", (1, 1, 1)), ("sp", (1, 1, 1)),
                          ("missing", (0.5, 0.5, 0.5))):
        a = jps.find_one_spectrum(name, default)
        b = pps.find_one_spectrum(name, default)
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert jps.find_one_float("a", 0) == pps.find_one_float("a", 0)
    assert jps.find_one_int("n", 0) == pps.find_one_int("n", 0)
    assert jps.find_one_bool("b", False) is pps.find_one_bool("b", False)
    assert jps.find_one_string("s", "") == pps.find_one_string("s", "")
    assert jps.find_texture_name("k") == pps.find_texture_name("k") == "tex"
    for f in ("find_point3", "find_normal3", "find_point2", "find_float"):
        name = {"find_point3": "P", "find_normal3": "N",
                "find_point2": "uv", "find_float": "a"}[f]
        np.testing.assert_array_equal(getattr(jps, f)(name),
                                      getattr(pps, f)(name))


def _mesh(seed=0, nv=50, nt=80):
    rng = np.random.RandomState(seed)
    return (rng.randn(nv, 3).astype(np.float32),
            rng.randint(0, nv, (nt, 3)).astype(np.int32),
            rng.randn(nv, 3).astype(np.float32),
            rng.rand(nv, 2).astype(np.float32))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("attrs", ["all", "positions"])
def test_ply_round_trip(tmp_path, binary, attrs):
    p, idx, n, uv = _mesh()
    if attrs == "positions":
        n = uv = None
    path = str(tmp_path / "m.ply")
    PPLY.write_ply(path, p, idx, n=n, uv=uv, binary=binary)
    jpath = str(tmp_path / "j.ply")
    JPLY.write_ply(jpath, p, idx, n=n, uv=uv, binary=binary)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, ref = PPLY.read_ply(path), JPLY.read_ply(path)
    for a, b, src in zip(got, ref, (p, n, uv, idx)):
        if src is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, src)


def _hdr_image(seed=3, h=5, w=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, 3) * np.array([1.0, 10.0, 100.0])
            ).astype(np.float32)


def test_exr_bytes_and_pixels_equal(tmp_path):
    img = _hdr_image()
    a, b = str(tmp_path / "p.exr"), str(tmp_path / "j.exr")
    PI.write_exr(a, img)
    JI.write_exr(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(PI.read_image(a), img)
    np.testing.assert_array_equal(PI.read_image(a), JI.read_image(a))


def test_pfm_and_hdr_readers_equal(tmp_path):
    img = _hdr_image()
    pfm = str(tmp_path / "x.pfm")
    with open(pfm, "wb") as f:
        f.write(b"PF\n7 5\n-1.0\n")
        f.write(img[::-1].astype("<f4").tobytes())
    np.testing.assert_array_equal(PI.read_image(pfm), JI.read_image(pfm))
    np.testing.assert_array_equal(PI.read_image(pfm), img)
    # flat RGBE scanlines
    hdr = str(tmp_path / "x.hdr")
    rng = np.random.RandomState(4)
    rgbe = rng.randint(0, 256, (5, 7, 4)).astype(np.uint8)
    with open(hdr, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 7\n")
        f.write(rgbe.tobytes())
    np.testing.assert_array_equal(PI.read_image(hdr), JI.read_image(hdr))


def _png8(path, px, ftype):
    """An 8-bit RGB PNG of ``px`` (H, W, 3) with every row filtered by
    ``ftype`` (the PNG specification's five filters)."""
    h, w, _ = px.shape
    bpp, stride = 3, w * 3
    rows, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), \
                np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


def _pixels(seed=5, h=24, w=33):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (128 + 100 * np.sin(np.stack([xx / 7.0, yy / 5.0,
                                           (xx + yy) / 9.0], -1)))
    noise = rng.randint(0, 256, (h, w, 3))
    return np.where((yy // 4 % 2 == 0)[..., None], noise, smooth) \
        .astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_each_row_filter(tmp_path, ftype):
    px = _pixels()
    path = str(tmp_path / f"f{ftype}.png")
    _png8(path, px, ftype)
    np.testing.assert_array_equal(PI.read_png8(path), px)
    np.testing.assert_array_equal(PI.read_image(path), JI.read_image(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_written_by_pil(tmp_path, mode):
    px = _pixels(seed=6, h=40, w=52)
    im = Image.fromarray(px)
    if mode == "RGBA":
        im = Image.fromarray(np.concatenate([px, px[..., :1]], -1))
    elif mode != "RGB":
        im = im.convert(mode)
    path = str(tmp_path / "pil.png")
    im.save(path)
    np.testing.assert_array_equal(PI.read_png8(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(PI.read_image(path), JI.read_image(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_tga_written_by_pil(tmp_path, mode, rle):
    px = _pixels(seed=7)
    px[:, :10] = px[:, :1]      # runs for the RLE packets
    im = Image.fromarray(px)
    if mode == "RGBA":
        im = Image.fromarray(np.concatenate([px, px[..., :1]], -1))
    elif mode == "L":
        im = im.convert("L")
    path = str(tmp_path / "pil.tga")
    im.save(path, **({"compression": "tga_rle"} if rle else {}))
    np.testing.assert_array_equal(PI.read_image(path), JI.read_image(path))


@pytest.mark.parametrize("ext", [".png", ".tga"])
def test_writers_decode_like_pil(tmp_path, ext):
    img = _hdr_image(h=9, w=11) / 50.0
    a, b = str(tmp_path / f"p{ext}"), str(tmp_path / f"j{ext}")
    PI.write_image(a, img)
    JI.write_image(b, img)
    np.testing.assert_array_equal(np.asarray(Image.open(a).convert("RGB")),
                                  np.asarray(Image.open(b).convert("RGB")))
    np.testing.assert_array_equal(PI.read_image(a), JI.read_image(b))


def test_spectrum_helpers_equal():
    from rustracer_tpu.core import spectrum as JS
    x = np.random.RandomState(8).rand(6, 3).astype(np.float32)
    np.testing.assert_array_equal(PS.srgb_decode_np(x), JS.srgb_decode_np(x))
    np.testing.assert_array_equal(PS.xyz_to_rgb_np(x[0]),
                                  JS.xyz_to_rgb_np(x[0]))
    np.testing.assert_array_equal(PS.blackbody_rgb(3200),
                                  JS.blackbody_rgb(3200))
    np.testing.assert_array_equal(PS.from_sampled([400, 550, 700], [1, 3, 2]),
                                  JS.from_sampled([400, 550, 700], [1, 3, 2]))
