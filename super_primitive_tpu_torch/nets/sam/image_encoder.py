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

Attention takes explicit scores plus the two decomposed rel-pos adds, the
JAX package's ``impl="xla"``, in float32 and in bf16 alike.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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
    # tanh-approximate GELU in the MLPs (the reduced-precision path only;
    # the float32 path keeps the exact erf GELU)
    gelu_approx: bool = False


VIT_H = ViTConfig()
VIT_B = ViTConfig(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11))
VIT_TINY_TEST = ViTConfig(
    img_size=64, embed_dim=32, depth=2, num_heads=2, window_size=2,
    global_attn_indexes=(1,), out_chans=16,
)


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


class Attention(nn.Module):
    """Multi-head attention over (B, H, W, C) with the decomposed rel-pos
    bias of an (H, W) = ``input_size`` grid."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        B, H, W, C = x.shape
        nh, L = self.num_heads, H * W
        hd = C // nh
        qkv = self.qkv(x.reshape(B, L, C)).reshape(B, L, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, L, hd).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W))
        out = attn.softmax(dim=-1) @ v
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
    over the ``grid`` of tokens."""

    def __init__(self, cfg: ViTConfig, window_size: int, grid: int):
        super().__init__()
        D = cfg.embed_dim
        self.window_size = window_size
        size = window_size if window_size > 0 else grid
        self.norm1 = LayerNorm(D)
        self.attn = Attention(D, cfg.num_heads, (size, size))
        self.norm2 = LayerNorm(D)
        self.mlp = MLPBlock(D, int(D * cfg.mlp_ratio), cfg.gelu_approx)

    def forward(self, x):
        shortcut = x
        h = self.norm1(x)
        if self.window_size > 0:
            H, W = h.shape[1], h.shape[2]
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw, (H, W))
        else:
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


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: ViTConfig = VIT_H):
        super().__init__()
        self.cfg = cfg
        S = cfg.img_size // cfg.patch_size
        D, C = cfg.embed_dim, cfg.out_chans
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, S, S, D))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size, S)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(D, C, 1, bias=False), LayerNorm2d(C),
            nn.Conv2d(C, C, 3, padding=1, bias=False), LayerNorm2d(C),
        )

    def forward(self, x):
        """(B, img_size, img_size, 3) -> (B, S, S, out_chans), S = img/patch."""
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
