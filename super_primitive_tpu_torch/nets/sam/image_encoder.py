"""SAM ViT image encoder (channels-last at its interfaces).

Port of ``super_primitive_tpu/nets/sam/image_encoder.py``: a ViT with a
16x16 patch embedding, an absolute position embedding, windowed attention
(window 14, the token grid zero-padded to a multiple of it) with periodic
global blocks, the decomposed relative position bias, and a two-conv
LayerNorm neck to 256 channels.  ViT-H: embed 1280, depth 32, heads 16,
global at 7/15/23/31.

Parameters carry the published segment-anything names (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``neck.0`` ...), so a segment-anything state dict
loads as it is.  Input (B, img, img, 3) and output (B, S, S, out_chans) are
the JAX package's channels-last layouts.

Normalisation follows the JAX package, not torch's defaults: the blocks'
``LayerNorm`` is flax's (eps 1e-6, statistics in float32 with the one-pass
variance max(0, E[x^2] - E[x]^2)), the neck's ``LayerNorm2d`` is two-pass
with eps 1e-6.

Attention has the JAX package's lowerings (``GLOBAL_ATTN_IMPLS``), chosen
per block kind by ``ViTConfig.global_attn_impl`` and ``windowed_attn_impl``:
"xla", explicit scores plus the two decomposed rel-pos adds; "ext", the
rel-pos folded into the QK contraction (:func:`extended_qk`); and "flash",
the extended heads through the hand-written attention kernel K4
(``ops/attention.py``), which never materialises the (L, L) scores.
``persistent_windows`` keeps the tokens in window layout across each run of
windowed blocks (the pad region re-zeroed after every ``norm1``).  All
lowerings share one parameter set and give the same valid-token math.
The JAX package's TPU layout and profiling variants ("ext_hp", "skip",
``skip_pad_compute``) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import attention as k4


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Sequence[int] = (7, 15, 23, 31)
    out_chans: int = 256
    # lowering of the GLOBAL attention blocks (one of GLOBAL_ATTN_IMPLS):
    # same parameters, same math
    global_attn_impl: str = "xla"
    # lowering of the WINDOWED blocks ("xla" or "ext")
    windowed_attn_impl: str = "xla"
    # partition into windows once per run of consecutive windowed blocks;
    # the pad region is re-zeroed after every norm1, so the math is the
    # per-block partition's
    persistent_windows: bool = False
    # tanh-approximate GELU in the MLPs (the reduced-precision path only;
    # the float32 path keeps the exact erf GELU)
    gelu_approx: bool = False


VIT_H = ViTConfig()
VIT_B = ViTConfig(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11))
VIT_TINY_TEST = ViTConfig(
    img_size=64, embed_dim=32, depth=2, num_heads=2, window_size=2,
    global_attn_indexes=(1,), out_chans=16,
)

# Attention lowerings, one parameter set for all:
#   "xla"    materialised scores plus the decomposed rel-pos adds;
#   "ext"    rel-pos folded into the QK contraction (extended heads);
#   "flash"  the extended heads through K4, ``ops.attention.ext_attention``
#            (no (L, L) scores in memory).
GLOBAL_ATTN_IMPLS = ("xla", "ext", "flash")


def config_from_state_dict(sd) -> ViTConfig:
    """The encoder configuration a segment-anything state dict was made for,
    read from its shapes: widths, depth, heads (from the rel-pos tables'
    head dim), window size and the global blocks (rel-pos tables as long as
    the token grid)."""
    w = sd["image_encoder.patch_embed.proj.weight"]
    D, P = int(w.shape[0]), int(w.shape[2])
    S = int(sd["image_encoder.pos_embed"].shape[1])
    depth = 0
    while f"image_encoder.blocks.{depth}.norm1.weight" in sd:
        depth += 1
    sizes = [(int(sd[f"image_encoder.blocks.{i}.attn.rel_pos_h"].shape[0]) + 1) // 2
             for i in range(depth)]
    windows = {s for s in sizes if s != S}
    hd = int(sd["image_encoder.blocks.0.attn.rel_pos_h"].shape[1])
    return ViTConfig(
        img_size=S * P, patch_size=P, embed_dim=D, depth=depth, num_heads=D // hd,
        mlp_ratio=int(sd["image_encoder.blocks.0.mlp.lin1.weight"].shape[0]) / D,
        window_size=windows.pop() if windows else ViTConfig.window_size,
        global_attn_indexes=tuple(i for i, s in enumerate(sizes) if s == S),
        out_chans=int(sd["image_encoder.neck.0.weight"].shape[0]),
    )


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: statistics in at least
    float32 with the one-pass variance max(0, E[x^2] - E[x]^2), eps 1e-6,
    (x - mean) * (rsqrt(var + eps) * weight) + bias, cast back to x's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        xf = _at_least_f32(x)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        return ((xf - mu) * mul + self.bias.to(xf.dtype)).to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of (B, C, H, W), two-pass, eps 1e-6, in at least
    float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        xf = _at_least_f32(x)
        mu = xf.mean(1, keepdim=True)
        var = ((xf - mu) ** 2).mean(1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + self.eps)
        w, b = self.weight.to(xf.dtype), self.bias.to(xf.dtype)
        return (y * w[:, None, None] + b[:, None, None]).to(x.dtype)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C) relative position embeddings from the
    (2 * size - 1, C) table; q_size == k_size, so no interpolation."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError(f"rel-pos table {tuple(rel_pos.shape)} for size {q_size}")
    dev = rel_pos.device
    relative = (torch.arange(q_size, device=dev)[:, None]
                - torch.arange(k_size, device=dev)[None, :] + (k_size - 1))
    return rel_pos[relative]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, hw):
    """attn (B, H*W, H*W) plus the decomposed rel-pos terms: the
    query-dependent row and column terms of q (B, H*W, C)."""
    H, W = hw
    B = q.shape[0]
    r_q = q.reshape(B, H, W, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, get_rel_pos(H, H, rel_pos_h))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, get_rel_pos(W, W, rel_pos_w))
    attn = attn.reshape(B, H, W, H, W) + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(B, H * W, H * W)


def extended_qk(q, k, rel_pos_h, rel_pos_w, hw, scale):
    """The decomposed rel-pos folded into the QK contraction.

    scores = (q * scale) @ k^T + rel_h + rel_w is q_ext @ k_ext^T with
      q_ext = [q * scale | q @ Rh[row_i]^T | q @ Rw[col_i]^T]   (B, L, C + H + W)
      k_ext = [k         | onehot(row_j)   | onehot(col_j)]
    since rel_h[i, j] depends on j only through row(j), rel_w through
    col(j).  q, k (B, L, C) over an (H, W) = ``hw`` grid, rows first."""
    H, W = hw
    B, L, _ = q.shape
    r_q = q.reshape(B, H, W, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, get_rel_pos(H, H, rel_pos_h)).reshape(B, L, H)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, get_rel_pos(W, W, rel_pos_w)).reshape(B, L, W)
    q_ext = torch.cat([q * scale, rel_h, rel_w], dim=-1)
    oh_row, oh_col = _onehots(H, W, q)
    k_ext = torch.cat([k, oh_row.expand(B, L, H), oh_col.expand(B, L, W)], dim=-1)
    return q_ext, k_ext


def _onehots(H: int, W: int, like: torch.Tensor):
    """(L, H) one-hot of each token's row and (L, W) of its column."""
    eye_h = torch.eye(H, dtype=like.dtype, device=like.device)
    eye_w = torch.eye(W, dtype=like.dtype, device=like.device)
    return eye_h.repeat_interleave(W, dim=0), eye_w.repeat(H, 1)


class Attention(nn.Module):
    """Multi-head attention over (B, H, W, C) with the decomposed rel-pos
    bias of an (H, W) = ``input_size`` grid, lowered as ``impl`` (one of
    ``GLOBAL_ATTN_IMPLS``)."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int],
                 impl: str = "xla"):
        super().__init__()
        if impl not in GLOBAL_ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads = num_heads
        self.impl = impl
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        B, H, W, C = x.shape
        nh, L = self.num_heads, H * W
        hd = C // nh
        scale = hd ** -0.5
        qkv = self.qkv(x.reshape(B, L, C)).reshape(B, L, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, L, hd).unbind(0)
        if self.impl == "xla":
            attn = (q * scale) @ k.transpose(-2, -1)
            attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W))
            out = attn.softmax(dim=-1) @ v
        else:
            q_ext, k_ext = extended_qk(q, k, self.rel_pos_h, self.rel_pos_w, (H, W), scale)
            if self.impl == "ext":
                out = (q_ext @ k_ext.transpose(-2, -1)).softmax(dim=-1) @ v
            else:  # "flash"
                out = k4.ext_attention(q_ext, k_ext, v.contiguous())  # a view when B * nh == nh
        out = out.reshape(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(out)


def window_partition(x, window: int):
    """(B, H, W, C) -> (B * nwh * nww, window, window, C) windows of the
    grid zero-padded to a multiple of ``window``, and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % window, (-W) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(windows, window: int, pad_hw, hw):
    """Inverse of :func:`window_partition`, cropped to ``hw``."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.reshape(B, Hp // window, Wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)[:, :H, :W]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_approx: bool):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x), approximate=self.approximate))


class Block(nn.Module):
    """Pre-norm transformer block; ``window_size`` 0 = global attention
    over the ``grid`` of tokens.  ``pre_windowed``: the
    input is already in window layout (persistent windows), whose pad
    tokens ``pad_mask`` re-zeroes after ``norm1``."""

    def __init__(self, cfg: ViTConfig, window_size: int, grid: int,
                 pre_windowed: bool = False):
        super().__init__()
        D = cfg.embed_dim
        self.window_size = window_size
        self.pre_windowed = pre_windowed
        size = window_size if window_size > 0 else grid
        impl = cfg.windowed_attn_impl if window_size > 0 else cfg.global_attn_impl
        self.norm1 = LayerNorm(D)
        self.attn = Attention(D, cfg.num_heads, (size, size), impl)
        self.norm2 = LayerNorm(D)
        self.mlp = MLPBlock(D, int(D * cfg.mlp_ratio), cfg.gelu_approx)

    def forward(self, x, pad_mask=None):
        shortcut = x
        h = self.norm1(x)
        if self.window_size > 0 and not self.pre_windowed:
            H, W = h.shape[1], h.shape[2]
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw, (H, W))
        else:
            if pad_mask is not None:
                h = h * pad_mask
            h = self.attn(h)
        x = shortcut + h
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        """(B, H, W, 3) -> (B, H/patch, W/patch, dim)."""
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def window_runs(cfg: ViTConfig) -> list[tuple[int, int]]:
    """[(i, j)]: the blocks i..j-1 of each run of consecutive windowed
    blocks, and (i, i + 1) for each global block, in order."""
    runs, i = [], 0
    while i < cfg.depth:
        j = i + 1
        if i not in cfg.global_attn_indexes:
            while j < cfg.depth and j not in cfg.global_attn_indexes:
                j += 1
        runs.append((i, j))
        i = j
    return runs


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: ViTConfig = VIT_H):
        super().__init__()
        self.cfg = cfg
        S = cfg.img_size // cfg.patch_size
        D, C, ws = cfg.embed_dim, cfg.out_chans, cfg.window_size
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, S, S, D))
        self.blocks = nn.ModuleList(
            Block(cfg, 0, S) if i in cfg.global_attn_indexes
            else Block(cfg, ws, S, pre_windowed=cfg.persistent_windows)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(D, C, 1, bias=False), LayerNorm2d(C),
            nn.Conv2d(C, C, 3, padding=1, bias=False), LayerNorm2d(C),
        )

    def forward(self, x):
        """(B, img_size, img_size, 3) -> (B, S, S, out_chans), S = img/patch."""
        cfg = self.cfg
        x = self.patch_embed(x) + self.pos_embed
        if not cfg.persistent_windows:
            for blk in self.blocks:
                x = blk(x)
        else:
            # one partition per run of windowed blocks; each block re-zeroes
            # the pad region after norm1 (pad_mask)
            B, H, W, _ = x.shape
            pad_mask = window_partition(x.new_ones(B, H, W, 1), cfg.window_size)[0]
            for i, j in window_runs(cfg):
                if i in cfg.global_attn_indexes:
                    x = self.blocks[i](x)
                    continue
                xw, pad_hw = window_partition(x, cfg.window_size)
                for k in range(i, j):
                    xw = self.blocks[k](xw, pad_mask)
                x = window_unpartition(xw, cfg.window_size, pad_hw, (H, W))
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
