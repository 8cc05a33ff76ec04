"""GDP loss and domain-balance weighting (counterpart of
regda_tpu/ops/losses_extra.py).

References: GDPLoss (gradient-density pixel weights over symmetric bins,
an EMA'd histogram), regda/gast/balance.py:218-303; DomainBalance,
examples_cnt and get_target_weight, regda/gast/domain_balance.py:15-70.
The histogram is explicit state, `GDPState`, threaded through the caller
as `ops.losses.GHMState` is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.labels import one_hot_ignore

EPS = 1e-7


@dataclass
class GDPState:
    acc_sum: torch.Tensor  # (bins,) EMA'd gradient histogram

    @staticmethod
    def create(bins: int = 30, device=None) -> 'GDPState':
        return GDPState(torch.zeros((bins,), dtype=torch.float32, device=device))


def gdp_loss(state: GDPState, logits: torch.Tensor, labels: torch.Tensor,
             momentum: float = 0.99, extra_pixel_weight: Optional[torch.Tensor] = None,
             n_extra: int = 0):
    """Gradient-density-weighted CE -> (loss, new state).

    The per-pixel gradient norm g = |p_y - 1| is counted into `bins` bins
    (int(g * bins); g = 1 in the last), the histogram symmetrised ((h +
    flip(h)) / 2) and EMA'd; a bin weighs 1 - acc / sum(acc) (0 where acc
    is 0), normalised by the largest, and a pixel takes the weight of the
    bin that bucketize over the edges k / bins names. Ignored pixels (< 0)
    weigh 0. `extra_pixel_weight` (B, H, W) adds to the weights, and the
    loss is divided by 1 + n_extra, the reference's (1 + refine + balance).
    logits (B, H, W, C), labels (B, H, W)."""
    bins = state.acc_sum.shape[0]
    c = logits.shape[-1]
    flat = logits.reshape(-1, c)
    lab = labels.reshape(-1)
    valid = lab >= 0
    onehot = one_hot_ignore(lab, c, -1).to(flat.dtype)
    with torch.no_grad():
        prob_y = (torch.softmax(flat, dim=-1) * onehot).sum(-1)
        gradient = torch.where(valid, torch.abs(prob_y - 1.0), -1.0)
        edges = torch.arange(bins + 1, dtype=torch.float32, device=flat.device) / bins
        edges[-1] += 1e-3
        in_range = (gradient >= 0.0) & (gradient <= 1.0)
        idx = torch.clamp((gradient * bins).to(torch.int32), 0, bins - 1).long()
        hist = torch.zeros(bins, dtype=torch.float32, device=flat.device).scatter_add_(
            0, idx, in_range.float())
        hist = (hist + torch.flip(hist, (0,))) * 0.5
        acc = momentum * state.acc_sum + (1 - momentum) * hist if momentum > 0 else hist
        w_bins = torch.where(acc != 0, 1.0 - acc / (acc.sum() + EPS), 0.0)
        w_bins = w_bins / (w_bins.amax() + EPS)
        inds = torch.bucketize(gradient, edges, right=False)
        pix_w = torch.where((inds > 0) & (inds <= bins),
                            w_bins[torch.clamp(inds - 1, 0, bins - 1)], 0.0)
    if extra_pixel_weight is not None:
        pix_w = pix_w + extra_pixel_weight.reshape(-1)
    ce = -(F.log_softmax(flat, dim=-1) * onehot).sum(-1)
    loss = (ce * pix_w * valid).sum() / (valid.sum() + EPS) / (1.0 + n_extra)
    return loss, GDPState(acc)


def examples_cnt(label_batches, ignore_label: int = -1, save_prob: bool = False,
                 channel_axis: int = 1) -> tuple[float, float]:
    """(valid pixel count, valid ratio) over an iterable of label arrays
    (numpy or tensors): (B, H, W) ids, or with `save_prob` probabilities
    whose class axis is `channel_axis` (domain_balance.py:20-35)."""
    cnt, cnt_all = 0.0, 0.0
    for lbl in label_batches:
        lbl = lbl.cpu().numpy() if isinstance(lbl, torch.Tensor) else np.asarray(lbl)
        if save_prob:
            lbl = lbl.argmax(axis=channel_axis)
        cnt += float((lbl != ignore_label).sum())
        cnt_all += float(lbl.size)
    return cnt, cnt / max(cnt_all, 1.0)


def target_domain_weight(cnt_s: float, ratio_s: float, cnt_t: float,
                         ratio_t: float) -> float:
    """The target domain's loss weight, clipped at 1 (domain_balance.py:38-40)."""
    weight = cnt_t * ratio_s / (cnt_s * ratio_t + EPS)
    return 1.0 if weight >= 1.0 else float(weight)
