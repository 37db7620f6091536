"""SAM's input frame made from the keyframe's image in one kernel, with its
plain version.

Replaces no Pallas kernel: the JAX package resizes the uint8 image twice
with ``cv2.resize(..., INTER_LINEAR)`` on the host, to the mask generation's
``infer_resolution`` and then the longest side to SAM's input, and the port
did the same in numpy (``image/resize.linear_resize``).  The CUDA C++ kernel
``csrc/sam_frame.cu``, built by ``_build`` at first use, composes the two on
the card: each output pixel forms the four intermediate pixels its taps need
in registers, so the intermediate frame is never written, in the uint8
path's fixed-point arithmetic on the same taps
(``image/resize.linear_taps_u8``), so the bytes are the same.

Dispatch is on the device of ``image``: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes :func:`sam_frame_reference`, the two
``linear_resize`` calls.  ``launch_counts["sam_frame"]`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..image.resize import linear_resize, linear_taps_u8
from . import _build

launch_counts = {"sam_frame": 0}


def reset_launch_counts() -> None:
    launch_counts["sam_frame"] = 0


def sam_frame_reference(image: torch.Tensor, mid_hw: tuple[int, int],
                        out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version: (H, W, 3) uint8 -> (h2, w2, 3) uint8, the image
    resized to ``mid_hw`` and that to ``out_hw``."""
    x = linear_resize(image.numpy(), tuple(mid_hw))
    return torch.from_numpy(linear_resize(x, tuple(out_hw)))


def tap_tables(src_hw: tuple[int, int], mid_hw: tuple[int, int],
               out_hw: tuple[int, int]) -> np.ndarray:
    """The kernel's int32 tables: stage 1's (sy0, sy1, ay0, sx0, sx1, ax0)
    from ``src_hw`` to ``mid_hw``, then stage 2's from ``mid_hw`` to
    ``out_hw``, one after another."""
    taps = (*linear_taps_u8(src_hw, mid_hw), *linear_taps_u8(mid_hw, out_hw))
    return np.concatenate(taps).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_tables(src_hw, mid_hw, out_hw, device: torch.device) -> torch.Tensor:
    """:func:`tap_tables` on ``device``, built once per shape and device."""
    return torch.from_numpy(tap_tables(src_hw, mid_hw, out_hw)).to(device)


def _lib():
    lib = _build.library("sam_frame.cu")
    if not getattr(lib, "_typed", False):
        _I, _P = ctypes.c_int, ctypes.c_void_p
        lib.sam_frame_launch.argtypes = [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P]
        lib.sam_frame_launch.restype = _I
        lib._typed = True
    return lib


def sam_frame(image: torch.Tensor, mid_hw: tuple[int, int],
              out_hw: tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) uint8 -> (h2, w2, 3) uint8 on ``image``'s device:
    ``linear_resize(linear_resize(image, mid_hw), out_hw)``."""
    mid_hw = (int(mid_hw[0]), int(mid_hw[1]))
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if image.device.type == "cpu":
        return sam_frame_reference(image, mid_hw, out_hw)
    if image.device.type != "cuda":
        raise ValueError(f"sam_frame: no kernel for device {image.device}")
    if image.dim() != 3 or image.shape[2] != 3 or image.dtype != torch.uint8:
        raise ValueError(f"sam_frame: image must be (H, W, 3) uint8, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("sam_frame: image must be contiguous")
    H, W = image.shape[:2]
    # int32 offsets; the launch's grid has out_hw[0] / 8 rows of blocks
    if (min(H, W, *mid_hw, *out_hw) < 1 or max(H * W, out_hw[0] * out_hw[1]) * 3 >= 2**31
            or out_hw[0] > 8 * 0xFFFF):
        raise ValueError(f"sam_frame: unsupported shapes {(H, W)} -> {mid_hw} -> {out_hw}")
    tables = _device_tables((H, W), mid_hw, out_hw, image.device)
    out = torch.empty((*out_hw, 3), dtype=torch.uint8, device=image.device)
    lib = _lib()
    with torch.cuda.device(image.device):
        err = lib.sam_frame_launch(
            image.data_ptr(), H, W, tables.data_ptr(), *mid_hw, *out_hw, out.data_ptr(),
            torch.cuda.current_stream(image.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"sam_frame: kernel launch failed with CUDA error {err}")
    launch_counts["sam_frame"] += 1
    return out
