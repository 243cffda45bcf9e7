"""Image read (PNG and JPEG) and PNG write, in OpenCV's layout.

The reference reads images with `cv2.imread(path)` (`aidet_tpu/data/
loader.py:88`, `aidet_tpu/apis/test.py:83`) and writes them with
`cv2.imwrite`; the card's machine has no OpenCV and no PIL, so the
port decodes and encodes images itself:

- `imread(path)` returns HWC uint8 **BGR**, as `cv2.imread(path,
  cv2.IMREAD_COLOR)`, dispatching on the file's first bytes:
  - PNG: non-interlaced 8-bit PNG of colour types 0 (grey, replicated
    to 3 channels), 2 (RGB), 3 (palette) and 6 (RGBA, alpha dropped),
    in zlib and numpy.  The row filters None, Sub and Up are vectorised
    (Sub, what OpenCV writes on every row, is a per-channel cumulative
    sum mod 256 along the row); Average and Paeth loop per byte.
  - JPEG (``FF D8``): baseline and extended sequential Huffman JPEG of
    1 or 3 components, luma 1x1, 2x1 or 2x2 over 1x1 chroma, restart
    intervals, decoded by the host library's C++ decoder
    (`csrc/jpeg_decode.cpp` through `hostlib`) in libjpeg-turbo's
    arithmetic, then turned by its EXIF orientation as cv2.imread turns
    it.
  Any other file (progressive JPEG, TIFF, 16-bit, interlaced, truncated
  or corrupt data, ...) raises `ValueError` naming it; a missing file
  raises `FileNotFoundError`.  Nothing is ever returned in place of an
  image.
- `imwrite(path, img)` writes an HWC uint8 BGR (or HW grey) image as a
  PNG whose rows all carry filter Sub.

tests/test_torch_port_data.py holds `imread` equal to `cv2.imread` on
the repo's PNGs and JPEGs and on hand-built PNGs of every filter and
colour type; tests/test_torch_port_jpeg.py holds the JPEG decoder equal
to it across qualities, samplings, sizes, restart intervals, optimised
tables and orientations.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
# channels of each colour type read here (0 grey, 2 RGB, 3 palette
# index, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _unfilter_row(kind, row, prev, bpp, path):
    """One row's bytes [n] uint8 from its filtered bytes and the row
    above (zeros above the first)."""
    if kind == 0:
        return row
    if kind == 1:
        return row.reshape(-1, bpp).cumsum(0, dtype=np.uint8).reshape(-1)
    if kind == 2:
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"{path}: PNG row filter {kind} is not 0-4")
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    for x in range(len(out)):
        left = out[x - bpp] if x >= bpp else 0
        if kind == 3:
            out[x] = (out[x] + ((left + up[x]) >> 1)) & 255
            continue
        upleft = up[x - bpp] if x >= bpp else 0
        p = left + up[x] - upleft
        pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up[x] if pb <= pc
                                                   else upleft)
        out[x] = (out[x] + pred) & 255
    return out.astype(np.uint8)


def imread(path) -> np.ndarray:
    """Decode the PNG or JPEG at ``path`` into an HWC uint8 BGR array."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SOI):
        return _read_jpeg(data, path)
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    return _read_png(data, path)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned by its EXIF orientation (1-8), as OpenCV's
    imread applies it (flips, transposes and their compositions)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _read_jpeg(data: bytes, path) -> np.ndarray:
    from .hostlib import decode_jpeg
    img, orientation = decode_jpeg(data, path)
    return _orient(img, orientation) if orientation != 1 else img


def _read_png(data: bytes, path) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace \
            or compression or filtering:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; only non-interlaced 8-bit PNG of "
            "colour types 0, 2, 3 and 6 is read")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    bpp = CHANNELS[colour]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, "
                         f"expected {h * (w * bpp + 1)}")
    rows = raw.reshape(h, w * bpp + 1)
    kinds, filtered = rows[:, 0], rows[:, 1:]
    if np.isin(kinds, (0, 1)).all():
        # every row independent of the one above: all at once
        pix = filtered.reshape(h, w, bpp)
        sub = kinds == 1
        pix = np.where(sub[:, None, None],
                       pix.cumsum(1, dtype=np.uint8), pix)
    else:
        pix = np.empty((h, w * bpp), np.uint8)
        prev = np.zeros(w * bpp, np.uint8)
        for y in range(h):
            prev = pix[y] = _unfilter_row(int(kinds[y]), filtered[y], prev,
                                          bpp, path)
        pix = pix.reshape(h, w, bpp)
    if colour == 0:
        return np.repeat(pix, 3, axis=2)
    if colour == 3:
        if int(pix.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE chunk")
        pix = palette[pix[..., 0]]
    return np.ascontiguousarray(pix[..., 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def imwrite(path, img: np.ndarray):
    """Write an HWC uint8 BGR image (or an HW grey one) as a PNG, every
    row filtered with Sub, compressed at zlib level 1 (OpenCV's
    default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) \
            or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"{path}: imwrite takes HxWx3 BGR or HxW grey "
                         f"uint8, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    pix = img[..., ::-1] if img.ndim == 3 else img[..., None]
    sub = pix.copy()
    sub[:, 1:] -= pix[:, :-1]
    rows = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, -1)],
                          1)
    colour = 2 if img.ndim == 3 else 0
    png = (SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                         0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return True
