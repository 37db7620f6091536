"""Plain float32 reference of SAM ViT-H: the image encoder (explicit
attention scores plus the decomposed relative-position terms, exact erf
GELU, windows partitioned in every windowed block), the prompt encoder and
the mask decoder, and the predictor's image preparation and point decode.

Frozen copy of ``super_primitive_tpu_torch/nets/sam/image_encoder.py``
(its "xla" lowering only), ``prompt_encoder.py``, ``mask_decoder.py`` and
the image half of ``predictor.py`` at commit 51882e36a88e.  The program
runs the encoder and decoder in bf16 with the extended-head attention in
persistent windows and tanh GELU; this file is the float32 mathematics it
approximates.  It imports nothing of the program.

``quantize`` (the control): every Linear, Conv2d and ConvTranspose2d takes
its weight and its input rounded to float8 e4m3 with one scale a tensor
(amax / 448), the precision below the program's bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .resize import linear_resize

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
    bias of an (H, W) = ``input_size`` grid: explicit scores plus the two
    decomposed rel-pos terms."""

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
        scale = hd ** -0.5
        qkv = self.qkv(x.reshape(B, L, C)).reshape(B, L, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, L, hd).unbind(0)
        attn = (q * scale) @ k.transpose(-2, -1)
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
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm transformer block; ``window_size`` 0 = global attention
    over the ``grid`` of tokens, else attention within zero-padded
    windows partitioned in this block."""

    def __init__(self, cfg: ViTConfig, window_size: int, grid: int):
        super().__init__()
        D = cfg.embed_dim
        self.window_size = window_size
        size = window_size if window_size > 0 else grid
        self.norm1 = LayerNorm(D)
        self.attn = Attention(D, cfg.num_heads, (size, size))
        self.norm2 = LayerNorm(D)
        self.mlp = MLPBlock(D, int(D * cfg.mlp_ratio))

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
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        S = cfg.img_size // cfg.patch_size
        D, C, ws = cfg.embed_dim, cfg.out_chans, cfg.window_size
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, S, S, D))
        self.blocks = nn.ModuleList(
            Block(cfg, 0, S) if i in cfg.global_attn_indexes
            else Block(cfg, ws, S)
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

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords01 in [0, 1], shape (..., 2) -> (..., 2 * num_pos_feats), in
        the Fourier matrix's dtype."""
        mat = self.positional_encoding_gaussian_matrix
        c = (2.0 * coords01.to(mat.dtype) - 1.0) @ mat
        c = (2.0 * math.pi) * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size=(64, 64),
                 input_image_size=(1024, 1024)):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2: box tl, 3: box br
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def forward(self, point_coords: torch.Tensor, point_labels: torch.Tensor):
        """Points (B, N, 2) in input-image pixels (x, y), labels (B, N) in
        {-1 pad, 0 negative, 1 positive}.  Pixel centres shift by +0.5 and
        coordinates normalise by (W, H); a label -1 takes the not-a-point
        embedding in place of the encoding.

        Returns (sparse (B, N, D), dense (B, H, W, D))."""
        wh = torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                          dtype=torch.float32, device=point_coords.device)
        pe = self.pe_layer((point_coords + 0.5) / wh)
        lab = point_labels[..., None]
        typed = torch.where(lab == 1, self.point_embeddings[1].weight[0],
                            self.point_embeddings[0].weight[0])
        sparse = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe + typed)
        H, W = self.image_embedding_size
        dense = self.no_mask_embed.weight[0].expand(point_coords.shape[0], H, W, self.embed_dim)
        return sparse, dense

    def get_dense_pe(self) -> torch.Tensor:
        """Positional encoding of the image-embedding grid, (1, H, W, D)."""
        H, W = self.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self.pe_layer(grid)[None]

class AttentionDS(nn.Module):
    """Multi-head attention with an internal width of embed_dim /
    downsample_rate; scores divide by sqrt(head dim)."""

    def __init__(self, embed_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        d = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, d)
        self.k_proj = nn.Linear(embed_dim, d)
        self.v_proj = nn.Linear(embed_dim, d)
        self.out_proj = nn.Linear(d, embed_dim)

    def _split(self, x):
        B, N, d = x.shape
        return x.reshape(B, N, self.num_heads, d // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        qh = self._split(self.q_proj(q))
        kh, vh = self._split(self.k_proj(k)), self._split(self.v_proj(v))
        attn = (qh @ kh.transpose(-2, -1)) / math.sqrt(qh.shape[-1])
        out = attn.softmax(dim=-1) @ vh
        B, nh, Nq, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, nh * hd))


class TokenMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = AttentionDS(embed_dim, num_heads)
        self.norm1 = LayerNorm(embed_dim)
        self.cross_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2)
        self.norm2 = LayerNorm(embed_dim)
        self.mlp = TokenMLP(embed_dim, mlp_dim)
        self.norm3 = LayerNorm(embed_dim)
        self.norm4 = LayerNorm(embed_dim)
        self.cross_attn_image_to_token = AttentionDS(embed_dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2)
        self.norm_final_attn = LayerNorm(embed_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (B, H, W, C), image_pe (1, H, W, C),
        point_embedding (B, N, C) -> (queries (B, N, C), keys (B, HW, C))."""
        B, H, W, C = image_embedding.shape
        keys = image_embedding.reshape(B, H * W, C)
        key_pe = image_pe.reshape(1, H * W, C).expand(B, H * W, C)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3):
        super().__init__()
        C = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(embed_dim=C, mlp_dim=8 * C)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2), LayerNorm2d(C // 4),
            nn.GELU(), nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(C, 256, self.num_mask_tokens, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt):
        """image_embeddings (1, H, W, C) shared across the B prompts,
        image_pe (1, H, W, C), sparse_prompt (B, N, C), dense_prompt
        (B, H, W, C).  Returns (masks (B, 4, 4H, 4W) logits, iou (B, 4))."""
        B = sparse_prompt.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1), sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        H, W, C = src.shape[1:]
        hs, src_out = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]

        up = self.output_upscaling(src_out.transpose(1, 2).reshape(B, C, H, W))
        hyper = torch.stack([mlp(mask_tokens_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        return masks, self.iou_prediction_head(iou_token_out)


PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    """The three SAM networks under their published segment-anything names."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        S = cfg.img_size // cfg.patch_size
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg.out_chans, (S, S), (cfg.img_size, cfg.img_size))
        self.mask_decoder = MaskDecoder(cfg.out_chans)


def build_sam(state_dict: dict, cfg: ViTConfig, device, quantize: bool = False) -> Sam:
    """A float32 :class:`Sam` on ``device`` holding a copy of
    ``state_dict`` (published names, every key), without gradients;
    ``quantize`` makes it the float8 control (module docstring)."""
    with torch.device("meta"):
        model = Sam(cfg)
    sd = {k: v.to(device=device, dtype=torch.float32, copy=True) for k, v in state_dict.items()}
    model.load_state_dict(sd, assign=True, strict=True)
    model = model.eval().requires_grad_(False)
    if quantize:
        to_fp8(model)
    return model


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (amax / 448), back in
    float32."""
    scale = torch.clamp(t.abs().amax(), min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def to_fp8(model: nn.Module) -> None:
    """Round every Linear, Conv2d and ConvTranspose2d weight of ``model`` to
    float8 and have each round its input the same way."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.data = _fp8(m.weight.data)
            m.register_forward_pre_hook(lambda _m, args: (_fp8(args[0]),) + tuple(args[1:]))


def preprocess_shape(h: int, w: int, target_length: int) -> tuple[int, int]:
    """Longest-side resize shape (SamPredictor.transform semantics)."""
    scale = target_length / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def encode(model: Sam, image_u8: np.ndarray) -> tuple[torch.Tensor, tuple[int, int]]:
    """(H, W, 3) uint8 image -> ((1, S, S, C) float32 features, the resized
    input frame (h2, w2)): longest side to the encoder's input (cv2
    INTER_LINEAR), normalised, zero-padded to the square, encoded."""
    T = model.cfg.img_size
    h2, w2 = preprocess_shape(*image_u8.shape[:2], T)
    dev = model.image_encoder.pos_embed.device
    img = torch.from_numpy(linear_resize(image_u8, (h2, w2))).to(dev)
    mean = torch.tensor(PIXEL_MEAN, device=dev)
    std = torch.tensor(PIXEL_STD, device=dev)
    x = (img.float() - mean) / std
    x = F.pad(x, (0, 0, 0, T - w2, 0, T - h2))[None]
    return model.image_encoder(x), (h2, w2)


def decode_points(model: Sam, features: torch.Tensor, pts: torch.Tensor):
    """Single positive point prompts (B, 2) float32 (x, y) in input-frame
    pixels, each with the label -1 pad point -> (low-res logits (B, 3,
    4S, 4S), IoU (B, 3)), the multimask output's masks 1..3."""
    B = pts.shape[0]
    coords = torch.stack([pts, torch.zeros_like(pts)], dim=1)
    labels = torch.tensor([1.0, -1.0], device=pts.device).expand(B, 2)
    sparse, dense = model.prompt_encoder(coords, labels)
    masks, iou = model.mask_decoder(features, model.prompt_encoder.get_dense_pe(), sparse, dense)
    return masks[:, 1:], iou[:, 1:]
