"""Extended-head attention kernel K4, with its plain version.

Port of the JAX package's ``impl="flash"`` global attention
(``super_primitive_tpu/nets/sam/image_encoder.py`` ``Attention.__call__``),
which hands the extended heads of :func:`nets.sam.image_encoder.extended_qk`
to the Pallas TPU flash-attention kernel with ``sm_scale=1``.  Here that
kernel is the CUDA C++ kernel ``csrc/ext_attention.cu``, built by ``_build``
at first use: two tensor-core bodies (``wgmma`` with TMA), bf16 products
for bf16 and 3xTF32 split products for float32, whose pre-pass writes K's
and V^T's TF32 halves into a scratch buffer the wrapper allocates.

It computes ``out[b] = softmax(q_ext[b] @ k_ext[b]^T) @ v[b]`` for
q_ext, k_ext (BH, L, D_qk) and v (BH, L, D_v), bf16 or float32, with no
scale (the extended heads carry it) and without materialising the (L, L)
scores: float32 accumulation, an online softmax, v's dtype out.

Dispatch is on the device of ``q_ext``: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes :func:`ext_attention_reference`.
``launch_counts["ext_attention"]`` counts launches.  The kernel takes
q_ext and k_ext widths that are multiples of 4 (float32) or 8 (bf16, with
v's) and 16-byte aligned rows: the wrapper pads other widths with zero
lanes (exact: a zero lane adds nothing to q . k, and v's extra columns are
sliced off), and copies a misaligned input.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the kernel's limits on the head widths (csrc/ext_attention.cu)
MAX_D_QK = 256
MAX_D_V = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the launch's own error codes
_LAUNCH_ERRORS = {-1: "libcuda has no cuTensorMapEncodeTiled",
                  -2: "libcuda refused a TMA tensor map"}

launch_counts = {"ext_attention": 0}


def reset_launch_counts() -> None:
    launch_counts["ext_attention"] = 0


def ext_attention_reference(q_ext: torch.Tensor, k_ext: torch.Tensor, v: torch.Tensor):
    """Plain version of K4: the (BH, L, L) scores materialised in float32,
    softmax in float32, the product with v in float32, v's dtype out."""
    s = q_ext.float() @ k_ext.float().transpose(-2, -1)
    return (s.softmax(dim=-1) @ v.float()).to(v.dtype)


def _lib():
    lib = _build.library("ext_attention.cu")
    if not getattr(lib, "_typed", False):
        _I, _P = ctypes.c_int, ctypes.c_void_p
        lib.ext_attention_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        lib.ext_attention_launch.restype = _I
        lib.ext_attention_scratch_floats.argtypes = [_I, _I, _I, _I, _I]
        lib.ext_attention_scratch_floats.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _lanes(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with its last dimension zero-padded to a multiple of n, in a fresh
    (aligned) tensor where it is not one already."""
    d = x.shape[-1]
    dn = -(-d // n) * n
    if dn == d and x.data_ptr() % 16 == 0:
        return x
    y = x.new_zeros(*x.shape[:-1], dn)
    y[..., :d] = x
    return y


def ext_attention(q_ext: torch.Tensor, k_ext: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: (q_ext (BH, L, D_qk), k_ext (BH, L, D_qk), v (BH, L, D_v)), one
    dtype (bf16 or float32) -> (BH, L, D_v) in v's dtype."""
    if q_ext.device.type == "cpu":
        return ext_attention_reference(q_ext, k_ext, v)
    if q_ext.device.type != "cuda":
        raise ValueError(f"ext_attention: no kernel for device {q_ext.device}")
    if not (q_ext.device == k_ext.device == v.device):
        raise ValueError("ext_attention: q_ext, k_ext and v must be on one device")
    if q_ext.dim() != 3 or k_ext.shape != q_ext.shape or v.dim() != 3 \
            or v.shape[:2] != q_ext.shape[:2]:
        raise ValueError(f"ext_attention: shapes {tuple(q_ext.shape)}, {tuple(k_ext.shape)}, "
                         f"{tuple(v.shape)}; want (BH, L, D_qk) twice and (BH, L, D_v)")
    if not (q_ext.dtype == k_ext.dtype == v.dtype) or q_ext.dtype not in _DTYPES:
        raise ValueError(f"ext_attention: dtypes {q_ext.dtype}, {k_ext.dtype}, {v.dtype}; "
                         "want one of float32, bfloat16")
    if not (q_ext.is_contiguous() and k_ext.is_contiguous() and v.is_contiguous()):
        raise ValueError("ext_attention: inputs must be contiguous")
    BH, L, d_qk = q_ext.shape
    d_v = v.shape[2]
    if not (1 <= d_qk <= MAX_D_QK and 1 <= d_v <= MAX_D_V) or BH < 1 or L < 1 \
            or BH > 65535 or BH * L * max(d_qk, d_v) >= 2**31:
        raise ValueError(f"ext_attention: unsupported BH={BH}, L={L}, D_qk={d_qk}, D_v={d_v}")
    if q_ext.dtype == torch.bfloat16:
        q_ext, k_ext, v_in = _lanes(q_ext, 8), _lanes(k_ext, 8), _lanes(v, 8)
    else:
        q_ext, k_ext, v_in = _lanes(q_ext, 4), _lanes(k_ext, 4), v
    out = torch.empty_like(v_in)
    lib = _lib()
    dtype = _DTYPES[q_ext.dtype]
    n_scratch = lib.ext_attention_scratch_floats(BH, L, q_ext.shape[2], v_in.shape[2], dtype)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q_ext.device) \
        if n_scratch else None
    with torch.cuda.device(q_ext.device):
        err = lib.ext_attention_launch(
            q_ext.data_ptr(), k_ext.data_ptr(), v_in.data_ptr(), out.data_ptr(), BH, L,
            q_ext.shape[2], v_in.shape[2], dtype,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q_ext.device).cuda_stream,
        )
    if err:
        raise RuntimeError("ext_attention: kernel launch failed: "
                           + _LAUNCH_ERRORS.get(err, f"CUDA error {err}"))
    launch_counts["ext_attention"] += 1
    return out if v_in is v else out[..., :d_v].contiguous()
