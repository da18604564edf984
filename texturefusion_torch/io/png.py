"""PNG files with the standard library alone (zlib, struct) and numpy.

The card's machine has no image library, so this module takes the place
of `cv2.imread` / `cv2.imwrite`: the textured export writes its atlas,
the keyframe dump its keyframes, and the TUM reader (io/tum.py) reads a
dataset's frames through it.

The writer writes 8-bit RGB ([H, W, 3] uint8) or 16-bit greyscale
([H, W] uint16, the TUM depth format), with one filter type for every
row (0 by default). The reader reads what libpng and OpenCV write for
those formats: 8-bit RGB, 8-bit RGBA (its alpha dropped) and 16-bit
greyscale, no interlace, any mix of the five row filters. Samples are
stored big-endian (PNG spec §7.1).

Unfiltering Sub, Average and Paeth needs the reconstructed byte to the
left, so a row cannot be decoded in one vectorised step. Pixel (r, x)
needs only (r, x-1), (r-1, x) and (r-1, x-1), so every pixel of an
anti-diagonal r + x = t can be decoded together once the diagonals
before it are: H + W - 1 vectorised steps decode a frame, each a few
numpy operations on strided views of the diagonal. Images whose rows
use only filters 0-2 take a row-by-row path (a cumulative sum for Sub).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (bytes a pixel, channels kept)
_FORMATS = {(8, 2): (3, 3), (8, 6): (4, 3), (16, 0): (2, 1)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG spec §9.4) on int16 arrays: with
    p = a + b - c, the neighbour nearest p, ties to a, then b."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Forward filter of [H, stride] uint8 scanlines, every row with
    `filter_type`; returns [H, 1 + stride] with the filter bytes."""
    h, stride = raw.shape
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                     # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                               # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]                  # up-left
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c) if filter_type == 4 else 0}
    out = np.empty((h, 1 + stride), np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = ((x - pred[filter_type]) & 0xFF).astype(np.uint8)
    return out


def write_png(path: str, image: np.ndarray, filter_type: int = 0) -> None:
    """Write an [H, W, 3] uint8 image (8-bit RGB) or an [H, W] uint16 one
    (16-bit greyscale, big-endian samples), every row with `filter_type`
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), compressed at zlib's
    fastest level (the atlas is tens of MB of mostly flat texture)."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        h, w, _ = image.shape
        raw, bpp, header = image.reshape(h, 3 * w), 3, (8, 2)
    elif image.dtype == np.uint16 and image.ndim == 2:
        h, w = image.shape
        raw = image.astype(">u2").view(np.uint8).reshape(h, 2 * w)
        bpp, header = 2, (16, 0)
    else:
        raise ValueError(f"write_png takes [H, W, 3] uint8 or [H, W] uint16, got "
                         f"{image.dtype} {image.shape}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type {filter_type} is not a PNG filter (0-4)")
    rows = _filter_rows(raw, bpp, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, header[0], header[1], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of filters 0-2 only: row by row, each one vectorised."""
    h, stride = filt.shape
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        f = filt[r]
        if types[r] == 0:
            out[r] = f
        elif types[r] == 2:
            out[r] = f + prior                       # uint8 wraps mod 256
        else:
            out[r] = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        prior = out[r]
    return out


def _unfilter_diagonals(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of filters: anti-diagonal by anti-diagonal. The image is
    stored skewed, diagonal-major: d[t + 2, r + 1] holds pixel (r, x) with
    t = r + x, so diagonal t is one contiguous row, its pixels' left
    neighbours are d[t + 1, r + 1], the upper ones d[t + 1, r] and the
    upper-left ones d[t, r]; the zero row r = -1 and the zero diagonals
    t = -2, -1 stand for the pixels outside the image."""
    h, stride = filt.shape
    w = stride // bpp
    n_diag = h + w - 1
    rr, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fd = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    fd[rr + xx + 2, rr + 1] = filt.reshape(h, w, bpp)
    d = np.zeros_like(fd)
    # per filter: a row mask, and its running count to skip absent filters
    masks = {k: (types == k)[:, None] for k in range(1, 5)}
    counts = {k: np.concatenate([[0], np.cumsum(m[:, 0])]) for k, m in masks.items()}
    pred = np.zeros((h, bpp), np.int16)
    for t in range(n_diag):
        lo, hi = max(0, t - w + 1), min(h - 1, t) + 1        # rows r of diagonal t
        a, b, c = d[t + 1, lo + 1:hi + 1], d[t + 1, lo:hi], d[t, lo:hi]
        p = pred[:hi - lo]
        p.fill(0)
        for k in range(1, 5):
            if counts[k][hi] == counts[k][lo]:
                continue
            v = a if k == 1 else b if k == 2 else (a + b) >> 1 if k == 3 else _paeth(a, b, c)
            np.copyto(p, v, where=masks[k][lo:hi])
        out = d[t + 2, lo + 1:hi + 1]
        np.add(fd[t + 2, lo + 1:hi + 1], p, out=out)
        np.bitwise_and(out, 0xFF, out=out)
    return d[rr + xx + 2, rr + 1].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Read a PNG: 8-bit RGB or RGBA → [H, W, 3] uint8 (alpha dropped),
    16-bit greyscale → [H, W] uint16. Raises on any other format, on
    interlace and on a bad CRC."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:4] not in _FORMATS or header[4:] != (0, 0, 0):
        raise ValueError(f"{path}: reads 8-bit RGB or RGBA and 16-bit greyscale without "
                         f"interlace; IHDR (width, height, bit depth, colour type, "
                         f"compression, filter, interlace) = {header}")
    w, h = header[0], header[1]
    bpp, keep = _FORMATS[header[2:4]]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + bpp * w)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: row filter type {int(types.max())} is not 0-4")
    filt = rows[:, 1:]
    if types.max(initial=0) <= 2:
        raw = _unfilter_rows(filt, types, bpp)
    else:
        raw = _unfilter_diagonals(filt, types, bpp)
    if header[2] == 16:
        return raw.view(">u2").reshape(h, w).astype(np.uint16)
    return np.ascontiguousarray(raw.reshape(h, w, bpp)[..., :keep])
