"""SAM mask decoder: the two-way transformer and the mask and IoU heads.

Port of ``super_primitive_tpu/nets/sam/mask_decoder.py`` with the published
segment-anything parameter names.  Image embeddings and their positional
encoding come channels-last, (1, H, W, C); per prompt the decoder returns
4 low-res mask logits (B, 4, 4H, 4W) and 4 IoU predictions.  Its
LayerNorms are flax's (``image_encoder.LayerNorm``, eps 1e-6, one-pass
float32 variance); the upscaling head's is ``LayerNorm2d``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .image_encoder import LayerNorm, LayerNorm2d


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
        qh, kh, vh = self._split(self.q_proj(q)), self._split(self.k_proj(k)), self._split(self.v_proj(v))
        attn = (qh @ kh.transpose(-2, -1)) / math.sqrt(qh.shape[-1])
        out = attn.softmax(dim=-1) @ vh
        B, nh, Nq, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, nh * hd))


class MLPBlock(nn.Module):
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
        self.mlp = MLPBlock(embed_dim, mlp_dim)
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
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 gelu_approx: bool = False):
        """``gelu_approx``: tanh GELU in the upscaling head (the
        reduced-precision path only; float32 keeps the exact erf)."""
        super().__init__()
        C = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(embed_dim=C, mlp_dim=8 * C)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        approximate = "tanh" if gelu_approx else "none"
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2), LayerNorm2d(C // 4),
            nn.GELU(approximate), nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2),
            nn.GELU(approximate),
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
