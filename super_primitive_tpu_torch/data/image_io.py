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
the whole of the unfiltering.  ``write_jpeg`` writes a baseline gray JPEG,
so a JPEG decoder can be driven on a machine without PIL or OpenCV.
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


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    W, H = struct.unpack(">II", head[16:24])
    return H, W


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
    return as_rgb(read_png(path), path)


def as_rgb(img: np.ndarray, path: str) -> np.ndarray:
    """A decoded 8-bit image as stored (gray, gray + alpha, RGB or RGBA) ->
    (H, W, 3) uint8 RGB."""
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


_ZIGZAG = np.array(sorted(((r, c) for r in range(8) for c in range(8)),
                          key=lambda rc: (rc[0] + rc[1],
                                          rc[1] if (rc[0] + rc[1]) % 2 == 0 else rc[0])))
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _jpeg_segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


JPEG_QUANT = 4  # write_jpeg's flat quantisation step


def write_jpeg(path, gray: np.ndarray):
    """Write a uint8 (H, W) image as a baseline (sequential DCT, Huffman)
    gray JPEG with a flat quantisation table of ``JPEG_QUANT``.

    The Huffman tables give every symbol a code of one fixed length (4 bits
    for the 12 DC categories, 8 for the 162 AC symbols): a valid prefix code
    that needs no table from the standard's annex."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError("write_jpeg takes a uint8 (H, W) image")
    H, W = gray.shape
    img = np.pad(gray.astype(np.float64) - 128, ((0, -H % 8), (0, -W % 8)), mode="edge")
    blocks = img.reshape(img.shape[0] // 8, 8, img.shape[1] // 8, 8).transpose(0, 2, 1, 3)
    coef = np.rint(_DCT @ blocks.reshape(-1, 8, 8) @ _DCT.T / JPEG_QUANT).astype(np.int64)
    zz = coef[:, _ZIGZAG[:, 0], _ZIGZAG[:, 1]]
    ac_symbols = [0x00, 0xF0] + [(run << 4) | size for run in range(16) for size in range(1, 11)]
    ac_code = {s: i for i, s in enumerate(ac_symbols)}
    bits: list[str] = []

    def put(value: int, size: int):
        """A category's extra bits (negative values as value - 1)."""
        if size:
            bits.append(format(value if value > 0 else value + (1 << size) - 1, f"0{size}b"))

    prev = 0
    for block in zz:
        diff = int(block[0]) - prev
        prev = int(block[0])
        size = abs(diff).bit_length()
        bits.append(format(size, "04b"))
        put(diff, size)
        run = 0
        nonzero = np.nonzero(block[1:])[0]
        last = nonzero[-1] + 1 if nonzero.size else 0
        for k in range(1, last + 1):
            v = int(block[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.append(format(ac_code[0xF0], "08b"))
                run -= 16
            size = abs(v).bit_length()
            bits.append(format(ac_code[(run << 4) | size], "08b"))
            put(v, size)
            run = 0
        if last < 63:
            bits.append(format(ac_code[0x00], "08b"))
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    scan = bytes(int(stream[i:i + 8], 2) for i in range(0, len(stream), 8))
    scan = scan.replace(b"\xff", b"\xff\x00")

    def dht(cls: int, length: int, symbols) -> bytes:
        counts = [0] * 16
        counts[length - 1] = len(symbols)
        return bytes([cls << 4]) + bytes(counts) + bytes(symbols)

    out = (b"\xff\xd8"
           + _jpeg_segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
           + _jpeg_segment(0xFFDB, bytes([0]) + bytes([JPEG_QUANT] * 64))
           + _jpeg_segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 1) + bytes([1, 0x11, 0]))
           + _jpeg_segment(0xFFC4, dht(0, 4, range(12)))
           + _jpeg_segment(0xFFC4, dht(1, 8, ac_symbols))
           + _jpeg_segment(0xFFDA, bytes([1, 1, 0x00, 0, 63, 0]))
           + scan + b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(out)
