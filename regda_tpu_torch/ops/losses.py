"""Losses the stage-1 and stage-2 steps use, and the class-balance EMA.

Counterpart of part of regda_tpu/ops/losses.py (reference: regda/gast/
balance.py:15-133, regda/loss.py:10-47, regda/gast/coral.py:15-47). Logits
are channel-last (B, H, W, C) or flat (N, C). Focal, GHM, UVEM and UPS are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.labels import one_hot_ignore

EPS = 1e-7


def softmax_cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_label: int = -1):
    """Per-pixel CE with ignore mask. Returns (loss (N,), valid (N,) bool)."""
    lg = logits.reshape(-1, logits.shape[-1])
    lb = labels.reshape(-1)
    valid = lb != ignore_label
    safe = torch.where(valid, lb, 0).long()
    nll = -torch.gather(F.log_softmax(lg, dim=-1), 1, safe[:, None])[:, 0]
    return torch.where(valid, nll, 0.0), valid


@dataclass
class ClassBalanceState:
    """EMA class-frequency tracker (balance.py:15-78)."""
    freq: torch.Tensor  # (C,)

    @staticmethod
    def create(num_classes: int, device=None) -> 'ClassBalanceState':
        return ClassBalanceState(
            torch.ones((num_classes,), dtype=torch.float32, device=device) / num_classes)


def class_balance_weights(state: ClassBalanceState, labels: torch.Tensor,
                          num_classes: int, ignore_label: int = -1,
                          decay: float = 0.99, temperature: float = 2.0):
    """Per-pixel weights from the EMA class frequency, and the updated EMA
    (ClassBalance.get_class_weight_4pixel, balance.py:27-43)."""
    lb = labels.reshape(-1)
    onehot = one_hot_ignore(lb, num_classes, ignore_label)
    local_cnt = (lb != ignore_label).sum().float()
    class_freq = onehot.sum(dim=0) / (local_cnt + EPS)
    freq = (1.0 - decay) * class_freq + decay * state.freq
    prob = torch.softmax((1.0 - freq) / temperature, dim=0)
    prob = prob / (prob.amax() + EPS)
    return onehot @ prob, ClassBalanceState(freq)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = -1,
                       pixel_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over all pixels, ignored ones counting 0 (balance.py:97-101)."""
    nll, _ = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    return nll.mean()


def ohem_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int = -1, thresh: float = 0.7,
                            pixel_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Online hard example mining CE (balance.py:104-133), as the JAX
    package computes it: keep the losses above -log(thresh), or, when fewer
    than n_valid // 5 are, every loss at or above the n_min-th largest;
    the mean over the kept pixels."""
    nll, valid = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    loss_thresh = -torch.log(torch.tensor(thresh, dtype=torch.float32))
    n_min = valid.sum() // 5
    sorted_desc = torch.sort(nll, descending=True).values
    kth = sorted_desc[torch.clamp(n_min - 1, 0, nll.shape[0] - 1)]
    hard = nll > loss_thresh
    keep = torch.where(hard.sum() >= n_min, hard, nll >= kth)
    kept = torch.where(keep, nll, 0.0)
    return kept.sum() / (keep.sum() + EPS)


def prototype_contrastive_loss(prototypes: torch.Tensor, feat: torch.Tensor,
                               labels: torch.Tensor, temperature: float = 8.0,
                               ignore_label: int = -1) -> torch.Tensor:
    """CE over cosine logits to detached prototypes, mean over valid pixels
    (regda/loss.py:10-47). feat (N, K) or (B, H, W, K)."""
    feat = feat.reshape(-1, feat.shape[-1])
    labels = labels.reshape(-1)
    protos = prototypes.detach()
    f = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-12)
    p = protos / (torch.linalg.vector_norm(protos, dim=-1, keepdim=True) + 1e-12)
    logits = (f @ p.T) / temperature
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(F.log_softmax(logits, dim=-1), 1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / (valid.sum() + EPS)


def coral_loss(source: torch.Tensor, target: torch.Tensor,
               is_sqrt: bool = False) -> torch.Tensor:
    """Deep CORAL (regda/gast/coral.py:15-47). source/target (N, K)."""
    d = source.shape[1]
    xm = source.mean(dim=0, keepdim=True) - source
    xc = (xm.T @ xm) / (source.shape[0] - 1)
    xmt = target.mean(dim=0, keepdim=True) - target
    xct = (xmt.T @ xmt) / (target.shape[0] - 1)
    loss = torch.sum((xc - xct) * (xc - xct))
    if is_sqrt:
        loss = torch.sqrt(loss)
    return loss / (4.0 * d * d)
