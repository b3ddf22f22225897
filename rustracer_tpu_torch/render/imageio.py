"""Image I/O (port of rustracer_tpu/render/imageio.py): PNG/TGA/EXR/HDR/PFM
read; PNG/TGA/EXR write.

The EXR (scanline, none/ZIP/ZIPS compression, half/float), Radiance HDR
(RGBE) and PFM code is the reference's, copied as it is. The reference
reads and writes PNG and TGA through PIL, which this package does not
need: both are decoded and encoded here with zlib and struct. Read: 8-bit
non-interlaced PNG of gray, gray-alpha, RGB, RGBA or palette colour, all
five row filters; uncompressed and RLE true-colour or gray TGA of 8, 24 or
32 bits. Like PIL's ``convert("RGB")`` the alpha channel is dropped and
gray is replicated. Written: 8-bit RGB PNG (filter 0 on every row) and
uncompressed 24-bit TGA, both through the same ``_to_srgb8``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..core.spectrum import srgb_decode_np

EXR_MAGIC = 20000630
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """-> (H, W, 3) float32 LINEAR RGB (8-bit formats are sRGB-decoded)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return srgb_decode_np(read_png8(path).astype(np.float32) / 255.0)
    if ext == ".tga":
        return srgb_decode_np(read_tga8(path).astype(np.float32) / 255.0)
    if ext == ".exr":
        return read_exr(path)
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".pfm":
        return read_pfm(path)
    raise ValueError(f"unsupported image format: {path} (this package reads "
                     "PNG, TGA, EXR, HDR and PFM)")


def _png_chunks(data: bytes, path: str):
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without IEND")


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters -> (h, stride) uint8. None, Sub and Up
    run on whole rows; Average and Paeth, whose bytes each depend on the
    one before, byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is short")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        pos = y * (stride + 1)
        ft = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if ft == 0:
            cur = line.copy()
        elif ft == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prior
        elif ft in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = cur
        prior = out[y]
    return out


def read_png8(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} is not read (8-bit "
                         "non-interlaced gray, RGB, palette, gray-alpha or "
                         "RGBA only)")
    px = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                       channels).reshape(h, w, channels)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return plte[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_tga8(path: str) -> np.ndarray:
    """Uncompressed or RLE true-colour (24/32-bit BGR(A)) or gray (8-bit)
    TGA -> (H, W, 3) uint8 RGB, top row first."""
    with open(path, "rb") as f:
        data = f.read()
    (id_len, cmap_type, img_type, _c0, _c1, _c2, _x0, _y0, w, h, depth,
     desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    gray = img_type in (3, 11)
    if cmap_type != 0 or img_type not in (2, 3, 10, 11) \
            or depth != (8 if gray else depth) \
            or (not gray and depth not in (24, 32)):
        raise ValueError(f"{path}: TGA of image type {img_type}, {depth} "
                         "bits is not read (true-colour 24/32-bit or gray "
                         "8-bit, raw or RLE)")
    bpp = depth // 8
    n = w * h * bpp
    pos = 18 + id_len
    if img_type in (2, 3):
        flat = np.frombuffer(data, np.uint8, n, pos)
    else:
        out = bytearray()
        while len(out) < n:
            head = data[pos]
            pos += 1
            count = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos:pos + bpp] * count
                pos += bpp
            else:
                out += data[pos:pos + bpp * count]
                pos += bpp * count
        flat = np.frombuffer(bytes(out[:n]), np.uint8)
    px = flat.reshape(h, w, bpp)
    rgb = np.repeat(px, 3, axis=2) if gray else px[..., [2, 1, 0]]
    if not desc & 0x20:          # bottom-left origin: rows stored bottom-up
        rgb = rgb[::-1]
    if desc & 0x10:              # right-to-left
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)


def read_pfm(path: str) -> np.ndarray:
    """PFM incl. endian handling (imageio.rs:179-246)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        color = header == b"PF"
        dims = f.readline().split()
        while len(dims) < 2:
            dims += f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), dtype=dtype, count=count)
        data = data.astype(np.float32) * abs(scale) if abs(scale) != 1.0 \
            else data.astype(np.float32)
        if color:
            img = data.reshape(h, w, 3)
        else:
            img = np.repeat(data.reshape(h, w, 1), 3, axis=2)
        return img[::-1].copy()  # PFM stores bottom-up


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr reader (imageio.rs:114-132)."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        # -Y H +X W
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 and \
                (data[pos + 2] << 8 | data[pos + 3]) == w:
            # RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x:x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x:x + cnt, c] = np.frombuffer(
                            data[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(data[pos:pos + 4 * w], np.uint8).reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * \
        np.where(exp[..., None] == 0, 0.0, 1.0)


def _read_exr_header(f):
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            break
        ty = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            ty += c
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (ty.decode(), f.read(size))
    return attrs


def _parse_chlist(data: bytes):
    chans = []
    pos = 0
    while data[pos] != 0:
        name = b""
        while data[pos] != 0:
            name += data[pos:pos + 1]
            pos += 1
        pos += 1
        ptype, = struct.unpack_from("<i", data, pos)
        pos += 16
        chans.append((name.decode(), ptype))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR scanline reader: compression none/ZIPS/ZIP,
    half/float channels (imageio.rs:134-160 capability parity)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != EXR_MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError(f"{path}: tiled/multipart EXR unsupported")
        attrs = _read_exr_header(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        if comp == 0:
            lines_per_chunk = 1
        elif comp == 2:
            lines_per_chunk = 1   # ZIPS
        elif comp == 3:
            lines_per_chunk = 16  # ZIP
        else:
            raise ValueError(f"{path}: EXR compression {comp} unsupported "
                             "(none/ZIP/ZIPS only)")
        n_chunks = -(-h // lines_per_chunk)
        f.read(8 * n_chunks)  # offset table (sequential read, ignore)
        dt = {1: np.float16, 2: np.float32}
        sizes = {1: 2, 2: 4}
        out = {name: np.zeros((h, w), np.float32) for name, _ in chans}
        chans_sorted = sorted(chans)  # storage is alphabetical by channel
        for _ in range(n_chunks):
            y, nbytes = struct.unpack("<ii", f.read(8))
            raw = f.read(nbytes)
            ny = min(lines_per_chunk, y1 - y + 1)
            expect = ny * sum(w * sizes[pt] for _, pt in chans_sorted)
            if comp in (2, 3):
                raw = zlib.decompress(raw)
                if len(raw) == expect:
                    # undo EXR predictor + interleave
                    arr = np.frombuffer(raw, np.uint8).astype(np.int16)
                    arr = np.cumsum(arr - 128, dtype=np.int64) % 256
                    arr2 = arr.astype(np.uint8)
                    half = (len(arr2) + 1) // 2
                    out_b = np.zeros(len(arr2), np.uint8)
                    out_b[0::2] = arr2[:half]
                    out_b[1::2] = arr2[half:]
                    raw = out_b.tobytes()
            pos = 0
            for line in range(ny):
                for name, pt in chans_sorted:
                    n = w * sizes[pt]
                    vals = np.frombuffer(raw[pos:pos + n], dt[pt]).astype(np.float32)
                    out[name][y - y0 + line] = vals
                    pos += n
    if all(k in out for k in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    first = next(iter(out.values()))
    return np.repeat(first[..., None], 3, -1)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_image(path: str, img: np.ndarray):
    """Linear RGB (H, W, 3) -> file by extension (PNG when there is none)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".png" or ext == "":
        write_png(path if ext else path + ".png", img)
    elif ext == ".exr":
        write_exr(path, img)
    elif ext == ".tga":
        write_tga(path, img)
    else:
        raise ValueError(f"unsupported output format {ext}")


def _to_srgb8(img):
    img = np.clip(img, 0.0, 1.0)
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.power(np.maximum(img, 1e-8), 1 / 2.4) - 0.055)
    return (np.clip(srgb, 0, 1) * 255 + 0.5).astype(np.uint8)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray):
    """Gamma-corrected 8-bit RGB PNG, every row filter 0."""
    px = _to_srgb8(img)
    h, w = px.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_tga(path: str, img: np.ndarray):
    """Gamma-corrected uncompressed 24-bit TGA, top row first."""
    px = _to_srgb8(img)
    h, w = px.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                            24, 0x20))
        f.write(np.ascontiguousarray(px[..., [2, 1, 0]]).tobytes())


def _exr_attr(name: str, ty: str, data: bytes) -> bytes:
    return name.encode() + b"\x00" + ty.encode() + b"\x00" + \
        struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray):
    """Uncompressed float32 scanline EXR writer (imageio.rs:76-92)."""
    h, w = img.shape[:2]
    chlist = b""
    for name in ("B", "G", "R"):
        chlist += name.encode() + b"\x00" + struct.pack("<i", 2) + \
            b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b""
    header += _exr_attr("channels", "chlist", chlist)
    header += _exr_attr("compression", "compression", b"\x00")
    header += _exr_attr("dataWindow", "box2i", box)
    header += _exr_attr("displayWindow", "box2i", box)
    header += _exr_attr("lineOrder", "lineOrder", b"\x00")
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", EXR_MAGIC, 2))
        f.write(header)
        offset0 = 8 + len(header) + 8 * h
        line_bytes = 8 + 3 * 4 * w
        for y in range(h):
            f.write(struct.pack("<Q", offset0 + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channels alphabetical: B, G, R
            f.write(img[y, :, 2].astype("<f4").tobytes())
            f.write(img[y, :, 1].astype("<f4").tobytes())
            f.write(img[y, :, 0].astype("<f4").tobytes())
