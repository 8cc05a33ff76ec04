"""SAM prompt encoder (counterpart of regda_tpu/models/sam/prompt.py):
random-Fourier positional encoding and point embeddings. Everything-mode
needs point prompts only, so box and mask prompts are not built; parameter
names are segment-anything's. All of it computes in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class PositionEmbeddingRandom(nn.Module):
    """Fourier-feature PE: coords in [0, 1]^2 -> (2 * num_pos_feats,) sin/cos."""

    def __init__(self, num_pos_feats: int = 128, scale: float = 1.0):
        super().__init__()
        self.register_buffer('positional_encoding_gaussian_matrix',
                             scale * torch.randn(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords01 - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid_pe(self, size: tuple[int, int]) -> torch.Tensor:
        """Dense PE over an (H, W) grid of half-pixel centres -> (H, W, C)."""
        h, w = size
        device = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing='xy'), dim=-1)  # (H, W, 2) x, y
        return self(grid)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024)):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2: box tl, 3: box br
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, embed_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        return self.pe_layer.grid_pe(self.image_embedding_size)   # (H, W, C)

    def forward(self, points: torch.Tensor, labels: torch.Tensor):
        """points: (B, N, 2) pixel xy in input-image coords; labels (B, N)
        with 1 = foreground, 0 = background, -1 = padding. Returns (sparse
        (B, N + 1, C), dense (B, H, W, C)): a padding point is appended, as
        SAM does when no box is given."""
        b = points.shape[0]
        pts = torch.cat([points, points.new_zeros((b, 1, 2))], dim=1) + 0.5
        lbs = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
        size = points.new_tensor([self.input_image_size[1], self.input_image_size[0]],
                                 dtype=torch.float32)
        pe = self.pe_layer(pts / size)                             # (B, N + 1, C)
        # not-a-point drops its PE entirely and takes the embedding alone
        emb = torch.where((lbs == -1)[..., None], self.not_a_point_embed.weight[0],
                          torch.where((lbs == 1)[..., None],
                                      pe + self.point_embeddings[1].weight[0],
                                      pe + self.point_embeddings[0].weight[0]))
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            b, *self.image_embedding_size, self.embed_dim)
        return emb, dense
