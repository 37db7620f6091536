"""The prefetching native image loader: PNG and JPEG decoded, and the fr1
undistort remap applied, on C++ threads ahead of the consumer.

Port of ``super_primitive_tpu/data/native_loader.py`` over the port's own
``data/csrc/loader.cpp`` (PNG on zlib alone, JPEG through libjpeg where
its header is found).  The library is compiled with ``g++`` from that
source at first use into ``build/host/`` beside the package, named by a
hash of its source and flags, written under a temporary name and moved
into place, so concurrent builds see all of it or nothing.  A build or
load that fails raises: there is no fallback decoder here.  Callers that
want the numpy decoder ask for it (``TUMDataset(native=False)``).

ctypes releases the GIL around every call into the library, and the
decode threads are C++ threads, so decoding never holds the interpreter
lock: the Python thread that launches the kernels keeps running while the
next frames decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .image_io import as_rgb

SOURCE = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-pthread")
_ERR_CAP = 1024

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _have_jpeg_header() -> bool:
    """Whether the C++ compiler finds ``jpeglib.h``."""
    proc = subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True)
    return proc.returncode == 0


def build_flags() -> tuple[str, ...]:
    """The compile and link flags: zlib always, libjpeg when its header is
    there."""
    jpeg = ("-DSP_HAVE_JPEG", "-ljpeg") if _have_jpeg_header() else ()
    return CXX_FLAGS + ("-lz",) + jpeg


def _library_path(flags: Sequence[str]) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"loader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; its path."""
    flags = build_flags()
    lib = _library_path(flags)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    compile_flags = [f for f in flags if not f.startswith("-l")]
    libs = [f for f in flags if f.startswith("-l")]
    proc = subprocess.run(["g++", *compile_flags, "-o", str(tmp), str(SOURCE), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_int, c_long, c_void_p = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
        int_p = ctypes.POINTER(c_int)
        f32_p, f64_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
        u8_p = ctypes.POINTER(ctypes.c_ubyte)
        lib.sp_has_jpeg.restype = c_int
        lib.sp_has_jpeg.argtypes = []
        lib.sp_loader_open.restype = c_void_p
        lib.sp_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int]
        lib.sp_loader_get.restype = c_long
        lib.sp_loader_get.argtypes = [c_void_p, c_int, u8_p, c_long, int_p, int_p, int_p,
                                      int_p, ctypes.c_char_p, c_int]
        lib.sp_loader_close.restype = None
        lib.sp_loader_close.argtypes = [c_void_p]
        lib.sp_loader_set_undistort.restype = None
        lib.sp_loader_set_undistort.argtypes = [c_void_p, f32_p, f32_p, c_int, c_int]
        lib.sp_undistort_maps.restype = None
        lib.sp_undistort_maps.argtypes = [f64_p, f64_p, c_int, c_int, f32_p, f32_p]
        lib.sp_remap_u8.restype = None
        lib.sp_remap_u8.argtypes = [u8_p, c_int, c_int, c_int, f32_p, f32_p, u8_p]
        _lib = lib
        return lib


def has_jpeg() -> bool:
    """Whether the built library decodes JPEG (``jpeglib.h`` was found)."""
    return bool(get_lib().sp_has_jpeg())


def default_threads() -> int:
    """Decode threads: four, but always one core left for the Python thread
    that launches the kernels."""
    return max(1, min(4, len(os.sched_getaffinity(0)) - 1))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def undistort_maps(K: np.ndarray, dist: np.ndarray, h: int, w: int):
    """(map_x, map_y) float32 (h, w): the remap tables of
    ``cv2.initUndistortRectifyMap`` with the new camera matrix equal to K,
    for the 5-term plumb-bob model (shorter vectors padded with zeros)."""
    d = np.asarray(dist, np.float64).reshape(-1)
    if d.size > 5:
        raise ValueError(f"{d.size} distortion terms: only the 5-term plumb-bob model "
                         "is implemented")
    d = np.ascontiguousarray(np.pad(d, (0, 5 - d.size)))
    K = np.ascontiguousarray(np.asarray(K, np.float64).reshape(9))
    mx = np.empty((h, w), np.float32)
    my = np.empty((h, w), np.float32)
    get_lib().sp_undistort_maps(_ptr(K, ctypes.c_double), _ptr(d, ctypes.c_double), h, w,
                                _ptr(mx, ctypes.c_float), _ptr(my, ctypes.c_float))
    return mx, my


def remap_u8(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap of a uint8 (h, w) or (h, w, c) image, constant-zero
    border, with the maps' (h, w) the image's."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8:
        raise ValueError(f"remap_u8 takes uint8 images, not {src.dtype}")
    h, w = src.shape[:2]
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != (h, w) or map_y.shape != (h, w):
        raise ValueError(f"maps {map_x.shape}, {map_y.shape} for an image of {(h, w)}")
    c = 1 if src.ndim == 2 else src.shape[2]
    dst = np.empty_like(src)
    get_lib().sp_remap_u8(_ptr(src, ctypes.c_ubyte), h, w, c, _ptr(map_x, ctypes.c_float),
                          _ptr(map_y, ctypes.c_float), _ptr(dst, ctypes.c_ubyte))
    return dst


class NativeImageLoader:
    """Prefetching loader over a fixed list of image files.

    ``loader[i]`` returns the image as stored: (H, W) for gray, else (H, W,
    C) in the file's channel order (JPEG decodes to RGB), uint8, or native
    uint16 for 16-bit PNG; :meth:`rgb` gives (H, W, 3) uint8 RGB as
    ``image_io.read_rgb`` does.  Getting index i schedules the decode of
    i+1 .. i+``lookahead`` on ``num_threads`` C++ threads (default
    :func:`default_threads`).  Each index has one consumer: call from one
    thread."""

    def __init__(self, paths: Sequence[str], num_threads: Optional[int] = None,
                 lookahead: int = 8):
        self.paths = [str(p) for p in paths]
        self._lib = get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        threads = default_threads() if num_threads is None else num_threads
        self._handle = self._lib.sp_loader_open(arr, len(self.paths), threads, lookahead)
        self._nbytes = 0
        self._err = ctypes.create_string_buffer(_ERR_CAP)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        if not 0 <= idx < len(self.paths):
            raise IndexError(f"image {idx} of {len(self.paths)}")
        h, w, c, bpc = (ctypes.c_int() for _ in range(4))
        buf = np.empty(self._nbytes, np.uint8)
        while True:
            rc = self._lib.sp_loader_get(
                self._handle, idx, _ptr(buf, ctypes.c_ubyte), buf.size, ctypes.byref(h),
                ctypes.byref(w), ctypes.byref(c), ctypes.byref(bpc), self._err, _ERR_CAP)
            if rc == -1:
                raise IOError(self._err.value.decode(errors="replace"))
            if rc == 0:
                break
            buf = np.empty(rc, np.uint8)  # the decoded image stays cached for this retry
        n = h.value * w.value * c.value * bpc.value
        self._nbytes = n
        raw = buf if buf.size == n else buf[:n].copy()
        img = raw.view(np.uint16 if bpc.value == 2 else np.uint8).reshape(
            h.value, w.value, c.value)
        return img[..., 0] if c.value == 1 else img

    def rgb(self, idx: int) -> np.ndarray:
        """Image ``idx`` as (H, W, 3) uint8 RGB: gray replicated, alpha
        dropped."""
        return as_rgb(self[idx], self.paths[idx])

    def set_undistort(self, map_x: np.ndarray, map_y: np.ndarray):
        """Remap the 8-bit images of the maps' size decoded from now on, on
        the decode threads; attach before consuming."""
        map_x = np.ascontiguousarray(map_x, np.float32)
        map_y = np.ascontiguousarray(map_y, np.float32)
        if map_x.shape != map_y.shape or map_x.ndim != 2:
            raise ValueError(f"maps of shapes {map_x.shape} and {map_y.shape}")
        h, w = map_x.shape
        self._lib.sp_loader_set_undistort(self._handle, _ptr(map_x, ctypes.c_float),
                                          _ptr(map_y, ctypes.c_float), h, w)

    def close(self):
        """Stop and join the decode threads."""
        if self._handle is not None:
            self._lib.sp_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
