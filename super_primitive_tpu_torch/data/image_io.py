"""The port's PNG reader and writer: stdlib ``zlib`` and numpy, no OpenCV
or PIL.

The JAX package's loaders decode with ``cv2.imread``; the card's host has
no OpenCV, so the port reads the PNG files of the TUM, Replica and VOID
layouts itself:

- 8-bit gray, gray + alpha, RGB and RGBA, and 16-bit of the same colour
  types (big-endian on disk, returned as native ``uint16``);
- all five row filters (None, Sub, Up, Average, Paeth).

Palette and interlaced files, bit depths below 8 and JPEG raise a
``ValueError`` that says so.

Sub, Average and Paeth make a pixel depend on its left neighbour, and
Up, Average and Paeth on the row above, so every file is unfiltered over
anti-diagonals of the image: pixel (r, c) needs only pixels of the two
diagonals before r + c, and each diagonal is one vectorised step
(H + W - 1 steps a frame, not H x W).

``write_png`` writes the same colour types; by default it cycles each
file's rows through all five filters, so every file it writes exercises
the whole of the unfiltering.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_COLOR_TYPE = {v: k for k, v in CHANNELS.items()}  # samples a pixel -> colour type
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays (PNG spec, section 9.4), with
    p - a = b - c, p - b = a - c and p - c = (a - c) + (b - c)."""
    d1, d2 = b - c, a - c
    pa, pb, pc = np.abs(d1), np.abs(d2), np.abs(d1 + d2)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(types: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal of pixels a step.

    ``Q`` holds the image skewed so that diagonal D = r + c is column
    D + 2 and pixel row r is row r + 1: row 0 is the zero row above the
    image and the columns of c < 0 stay zero, as the filters define them.
    Rows of a diagonal past the image's right edge compute values that only
    other such cells read."""
    H, rowbytes = filt.shape
    W = rowbytes // bpp
    F = filt.reshape(H, W, bpp).astype(np.int16)
    ndiag = H + W - 1
    rr = np.arange(H)[:, None]
    cc = np.arange(ndiag)[None, :] - rr
    inside = (cc >= 0) & (cc < W)
    G = np.zeros((H, ndiag, bpp), np.int16)
    G[inside] = F[np.broadcast_to(rr, inside.shape)[inside], cc[inside]]
    Q = np.zeros((H + 1, ndiag + 2, bpp), np.int16)
    kinds = sorted(set(types.tolist()))
    sel = types.astype(np.intp)[:, None]
    zero = np.zeros((H, bpp), np.int16)
    for D in range(ndiag):
        n = min(H, D + 1)
        a = Q[1:n + 1, D + 1]  # left
        b = Q[0:n, D + 1]      # up
        c = Q[0:n, D]          # up-left
        preds = [zero[:n], a, b,
                 (a + b) >> 1 if 3 in kinds else zero[:n],
                 paeth(a, b, c) if 4 in kinds else zero[:n]]
        pred = preds[kinds[0]] if len(kinds) == 1 else np.choose(sel[:n], preds)
        np.bitwise_and(G[:n, D] + pred, 0xFF, out=Q[1:n + 1, D + 2])
    cols = np.arange(H)[:, None] + np.arange(W)[None, :] + 2
    return Q[np.arange(1, H + 1)[:, None], cols].astype(np.uint8).reshape(H, rowbytes)


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of decompressed image data -> (height,
    rowbytes) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, "
                         f"{height * (rowbytes + 1)} expected")
    data = data[: height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    types, filt = data[:, 0], data[:, 1:]
    if types.size and int(types.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    return _unfilter_diagonals(types, filt, bpp)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file as stored: (H, W) for gray, else (H, W, C) in the
    file's channel order (RGB, RGBA, gray + alpha); uint8, or native uint16
    for 16-bit files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: JPEG files are not supported by the port's reader "
                         "(PNG only)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if color == 3:
        raise ValueError(f"{path}: palette PNG files are not supported")
    if color not in CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit {_COLOR_NAMES[color]} PNG files are not "
                         "supported (8 or 16 bits only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    ch = CHANNELS[color]
    bpp = ch * depth // 8
    rows = unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(H, W, ch)
    return img[..., 0] if ch == 1 else img


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG as (H, W, 3) uint8 RGB, as ``cv2.imread(path)`` followed
    by BGR -> RGB gives it: gray replicated to three channels, alpha
    dropped."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit image where an 8-bit colour image is expected")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray, filters=(0, 1, 2, 3, 4)):
    """Write a uint8 or uint16 (H, W) gray or (H, W, C) gray + alpha, RGB or
    RGBA image as a PNG; row r is filtered with ``filters[r % len]``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"cannot write {img.dtype} as PNG")
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    bpp = ch * depth // 8
    x = raw.reshape(H, W * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    residuals = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth(a, b, c)])
    kinds = np.asarray(filters)[np.arange(H) % len(filters)]
    rows = (residuals[kinds, np.arange(H)] & 0xFF).astype(np.uint8)
    data = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data.tobytes(), 6)) + _chunk(b"IEND", b""))
