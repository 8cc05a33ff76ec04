"""Class-aware feature whitening loss (counterpart of regda_tpu/ops/whiten.py).

Reference: regda/gast/class_ware_whiten.py:14-65 (`ClassWareWhitening`,
which no regda tool calls). Golden value: the reference's 1x4x6x1 example
evaluates to 12.4375 (class_ware_whiten.py:68-80).

For each class id and each channel group, the covariance of the
class-masked (zero-filled) feature rows, and its mean squared distance to
the identity; the classes and groups are a batch dimension of one chain of
matrix products.
"""

from __future__ import annotations

from typing import Sequence

import torch


def masked_covariance(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Covariance of masked feature rows, the zeros outside the mask kept in
    the product (the reference's zero fill). feats (..., N, K), mask (..., N)
    0/1 -> (..., K, K); the identity where the mask selects one row or none."""
    k = feats.shape[-1]
    num = mask.sum(dim=-1)[..., None, None]
    x_masked = feats * mask[..., None]
    mean = x_masked.sum(dim=-2, keepdim=True) / torch.clamp(num, min=1.0)
    x_centered = x_masked - mean * mask[..., None]
    cov = x_centered.transpose(-1, -2) @ x_centered / torch.clamp(num - 1.0, min=1.0)
    eye = torch.eye(k, dtype=feats.dtype, device=feats.device)
    return torch.where(num > 1, cov, eye)


def class_ware_whitening(feats: torch.Tensor, labels: torch.Tensor,
                         class_ids: Sequence[int], groups: int = 1) -> torch.Tensor:
    """Sum over classes and channel groups of mean((cov - I)^2).
    feats (B, H, W, K) (NHWC), labels (B, H, W) ids; K % groups == 0."""
    k = feats.shape[-1]
    if k % groups:
        raise ValueError(f'{k} channels do not divide into {groups} groups')
    step = k // groups
    flat = feats.reshape(-1, k)
    lab = labels.reshape(-1)
    masks = torch.stack([(lab == c).to(feats.dtype) for c in class_ids])       # (C, N)
    grouped = flat.reshape(-1, groups, step).permute(1, 0, 2)                  # (G, N, step)
    cov = masked_covariance(grouped[None], masks[:, None])                     # (C, G, s, s)
    eye = torch.eye(step, dtype=feats.dtype, device=feats.device)
    return ((cov - eye) ** 2).mean(dim=(-1, -2)).sum()
