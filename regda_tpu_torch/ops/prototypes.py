"""Class prototypes: Pearson distance, batch-local prototypes, EMA updates.

Counterpart of regda_tpu/ops/prototypes.py (reference: regda/gast/
alignment.py:86-126, 300-327, 396-438). The (C, K) prototype matrix and the
running (sum, cnt) accumulators are plain tensors the caller owns. With a
`group` (parallel.DataGroup), the per-class sums and counts are those of
the global batch, so every rank holds the same prototypes.
"""

from __future__ import annotations

from typing import Optional

import torch

from regda_tpu_torch.parallel.mesh import DataGroup, all_reduce_sum

EPS = 1e-7


def ema(history: torch.Tensor, curr: torch.Tensor, decay: float) -> torch.Tensor:
    return (1.0 - decay) * curr + decay * history


def pearson_dist(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """Pairwise Pearson distance in [0, 1]. feat1 (N, K), feat2 (M, K) -> (N, M)."""
    k = feat1.shape[-1]
    c1 = feat1 - feat1.mean(dim=-1, keepdim=True)
    c2 = feat2 - feat2.mean(dim=-1, keepdim=True)
    cov = (c1 @ c2.T) / (k - 1 + EPS)
    std1 = feat1.std(dim=-1, correction=1)[:, None]
    std2 = feat2.std(dim=-1, correction=1)[None, :]
    return (-1.0 * cov / (std1 * std2 + EPS) + 1.0) * 0.5


def local_prototypes(feat: torch.Tensor, label_onehot: torch.Tensor,
                     fallback: torch.Tensor,
                     group: Optional[DataGroup] = None) -> torch.Tensor:
    """Per-class mean of feat (N, K) under label_onehot (N, C) -> (C, K);
    classes with no pixel take `fallback` (alignment.py:319-322)."""
    sums = all_reduce_sum(label_onehot.T @ feat, group)
    counts = all_reduce_sum(label_onehot.sum(dim=0)[:, None], group)
    local = sums / (counts + EPS)
    return torch.where(counts < 1, fallback, local)


def prototype_update(prototypes: torch.Tensor, feat: torch.Tensor,
                     label_onehot: torch.Tensor, decay: float = 0.996,
                     group: Optional[DataGroup] = None) -> torch.Tensor:
    """EMA update of the global prototypes from a batch (alignment.py:86-90)."""
    return ema(prototypes, local_prototypes(feat, label_onehot, prototypes, group), decay)


def prototype_accumulate(data_sum: torch.Tensor, data_cnt: torch.Tensor,
                         feat: torch.Tensor, label_onehot: torch.Tensor,
                         group: Optional[DataGroup] = None):
    """Running-sum accumulation for prototype init (alignment.py:107-119)."""
    return (data_sum + all_reduce_sum(label_onehot.T @ feat, group),
            data_cnt + all_reduce_sum(label_onehot.sum(dim=0)[:, None], group))


def prototype_finalize(data_sum: torch.Tensor, data_cnt: torch.Tensor) -> torch.Tensor:
    """alignment.py:121-122."""
    return data_sum / (data_cnt + EPS)
