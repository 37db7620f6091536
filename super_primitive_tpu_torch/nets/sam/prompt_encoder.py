"""SAM prompt encoder: random-Fourier positional encoding, the learned
point-type embeddings (negative, positive, box corners, not-a-point) and
the no-mask dense embedding.

Port of ``super_primitive_tpu/nets/sam/prompt_encoder.py`` with the
published segment-anything parameter names; outputs are channels-last.
"""

from __future__ import annotations

import math

import torch
from torch import nn


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
