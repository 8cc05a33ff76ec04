"""The loss zoo of the three stages and the class-balance EMA.

Counterpart of regda_tpu/ops/losses.py (reference: regda/gast/balance.py
:15-457, regda/loss.py:10-47, regda/gast/coral.py:15-47, regda/gast/mmd.py
:15-58). Logits are channel-last (B, H, W, C) or flat (N, C). Losses that
carry state across steps (the class-frequency EMA, the GHM histogram) take
it and return the updated one.

UPS and UVEM keep the reference's entropy of the soft label, -p log(p + 0):
a probability of exactly 0 gives a NaN entropy, which is neither above nor
at-or-below the threshold, so such a pixel keeps its loss in the sum but
leaves the count that divides it. The port reproduces that.

Every loss and state update takes `group`, a `parallel.DataGroup`: with
one, the sums, counts, moments and order statistics are those of the
global batch over the ranks, and every rank returns the same global loss
(parallel/mesh.py says how its gradient comes out right); without one,
nothing changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.labels import one_hot_ignore
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners
from regda_tpu_torch.parallel.mesh import DataGroup, all_gather_rows, all_reduce_sum, global_mean

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
                          decay: float = 0.99, temperature: float = 2.0,
                          group: Optional[DataGroup] = None):
    """Per-pixel weights from the EMA class frequency, and the updated EMA
    (ClassBalance.get_class_weight_4pixel, balance.py:27-43)."""
    lb = labels.reshape(-1)
    onehot = one_hot_ignore(lb, num_classes, ignore_label)
    local_cnt = all_reduce_sum((lb != ignore_label).sum().float(), group)
    class_freq = all_reduce_sum(onehot.sum(dim=0), group) / (local_cnt + EPS)
    freq = (1.0 - decay) * class_freq + decay * state.freq
    prob = torch.softmax((1.0 - freq) / temperature, dim=0)
    prob = prob / (prob.amax() + EPS)
    return onehot @ prob, ClassBalanceState(freq)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = -1,
                       pixel_weight: Optional[torch.Tensor] = None,
                       group: Optional[DataGroup] = None) -> torch.Tensor:
    """Mean CE over all pixels, ignored ones counting 0 (balance.py:97-101)."""
    nll, _ = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    return global_mean(nll, group)


def ohem_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int = -1, thresh: float = 0.7,
                            pixel_weight: Optional[torch.Tensor] = None,
                            group: Optional[DataGroup] = None) -> torch.Tensor:
    """Online hard example mining CE (balance.py:104-133), as the JAX
    package computes it: keep the losses above -log(thresh), or, when fewer
    than n_valid // 5 are, every loss at or above the n_min-th largest;
    the mean over the kept pixels. With a group, n_valid, the count above
    the threshold and the n_min-th largest loss are the global batch's:
    every rank sorts the gathered losses of all ranks."""
    nll, valid = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    loss_thresh = -torch.log(torch.tensor(thresh, dtype=torch.float32))
    n_min = all_reduce_sum(valid.sum(), group) // 5
    every = all_gather_rows(nll, group)
    sorted_desc = torch.sort(every, descending=True).values
    kth = sorted_desc[torch.clamp(n_min - 1, 0, every.shape[0] - 1)]
    hard = nll > loss_thresh
    keep = torch.where(all_reduce_sum(hard.sum(), group) >= n_min, hard, nll >= kth)
    kept = torch.where(keep, nll, 0.0)
    return all_reduce_sum(kept.sum(), group) / (all_reduce_sum(keep.sum(), group) + EPS)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               ignore_label: int = -1, group: Optional[DataGroup] = None) -> torch.Tensor:
    """balance.py:136-158: mean over all pixels of (1 - p_y)^gamma * CE,
    ignored pixels counting 0."""
    nll, _ = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    pt = torch.exp(-nll)
    return global_mean((1.0 - pt) ** gamma * nll, group)


@dataclass
class GHMState:
    """30-bin gradient-density histogram EMA (balance.py:161-215)."""
    acc_sum: torch.Tensor  # (bins,)

    @staticmethod
    def create(bins: int = 30, device=None) -> 'GHMState':
        return GHMState(torch.zeros((bins,), dtype=torch.float32, device=device))


def ghm_loss(state: GHMState, logits: torch.Tensor, labels: torch.Tensor,
             bins: int = 30, momentum: float = 0.99, ignore_label: int = -1,
             group: Optional[DataGroup] = None):
    """Gradient-harmonized CE (balance.py:161-215) -> (loss, new state).

    The histogram counts g = |p_y - 1| of the valid pixels by `histc`'s
    binning (int(g * bins), g = 1 in the last bin); the weight of a pixel
    is 1 / acc of the bin that `bucketize` over the edges k / bins names
    (the first edge >= g), as the JAX package computes them, so the two
    binnings may name different bins at g = k / bins, and an empty bin
    gives an infinite weight. g = 0 and ignored pixels weigh 0."""
    lg = logits.reshape(-1, logits.shape[-1])
    lb = labels.reshape(-1)
    valid = lb != ignore_label
    with torch.no_grad():
        probs = torch.softmax(lg, dim=-1)
        onehot = one_hot_ignore(lb, lg.shape[-1], ignore_label)
        gradient = torch.abs((probs * onehot).sum(dim=-1) - 1.0)
        gradient = torch.where(valid, gradient, -1.0)   # below every bin
        edges = torch.cat([
            torch.arange(bins, dtype=torch.float32, device=lg.device) / bins,
            torch.tensor([1.0 + 1e-3], dtype=torch.float32, device=lg.device)])
        in_range = (gradient >= 0.0) & (gradient <= 1.0)
        idx = torch.clamp((gradient * bins).to(torch.int32), 0, bins - 1).long()
        hist = all_reduce_sum(torch.zeros(
            bins, dtype=torch.float32, device=lg.device).scatter_add_(0, idx, in_range.float()),
            group)
        inds = torch.bucketize(gradient, edges, right=False)
        acc = momentum * state.acc_sum + (1.0 - momentum) * hist if momentum > 0 else hist
        w = torch.where((inds > 0) & (inds <= bins),
                        1.0 / acc[torch.clamp(inds - 1, 0, bins - 1)], 0.0)
    nll, _ = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    loss = (all_reduce_sum((nll * w).sum(), group)
            / (all_reduce_sum(valid.sum(), group) + EPS))
    return loss, GHMState(acc)


def _soft_entropy(label_soft_flat: torch.Tensor) -> torch.Tensor:
    # + 0.0, as the reference: p = 0 gives 0 * -inf = NaN (module docstring)
    return torch.sum(-label_soft_flat * torch.log(label_soft_flat + 0.0), dim=-1)


def ups_loss(logits: torch.Tensor, labels: torch.Tensor, label_soft: torch.Tensor,
             threshold: float = 0.7, ignore_label: int = -1,
             pixel_weight: Optional[torch.Tensor] = None,
             group: Optional[DataGroup] = None) -> torch.Tensor:
    """Entropy-gated CE (balance.py:306-342); label_soft (B, H, W, C)
    probabilities."""
    nll, valid = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    unc = _soft_entropy(label_soft.reshape(-1, label_soft.shape[-1]))
    nll = torch.where(unc > threshold, 0.0, nll)
    if pixel_weight is not None:
        nll = nll * pixel_weight
    valid_cnt = all_reduce_sum(((unc <= threshold) & valid).sum(), group)
    return all_reduce_sum(nll.sum(), group) / (valid_cnt + EPS)


def uvem_weight(uncertainty: torch.Tensor, m: float = 0.2, threshold: float = 0.7,
                gamma: float = 4.0) -> torch.Tensor:
    """Piecewise-quadratic valuable-example weight (balance.py:396-423)."""
    u = uncertainty
    if m > 0:
        left = torch.clamp((-1.0 / m ** 2) * (u - m) ** 2 + 1.0, 0.0, 1.0) ** (1.0 / gamma)
    else:
        left = torch.ones_like(u)
    if m < threshold:
        # outside (m, t] the reference evaluates the parabola at u = 0
        u_right = torch.where((u > m) & (u <= threshold), u, 0.0)
        right = torch.clamp((-1.0 / (threshold - m) ** 2) * (u_right - m) ** 2 + 1.0,
                            0.0, 1.0) ** (1.0 / gamma)
    else:
        right = torch.zeros_like(u)
    w = torch.where(u <= m, left, right)
    return torch.where(u >= threshold, 0.0, w)


def uvem_loss(logits: torch.Tensor, labels: torch.Tensor, label_soft: torch.Tensor,
              m: float = 0.2, threshold: float = 0.7, gamma: float = 4.0,
              ignore_label: int = -1,
              pixel_weight: Optional[torch.Tensor] = None,
              group: Optional[DataGroup] = None) -> torch.Tensor:
    """Uncertainty-based valuable example mining (balance.py:345-394)."""
    nll, valid = softmax_cross_entropy_ignore(logits, labels, ignore_label)
    unc = _soft_entropy(label_soft.reshape(-1, label_soft.shape[-1]))
    nll = torch.where(unc > threshold, 0.0, nll)
    w = uvem_weight(unc, m, threshold, gamma)
    if pixel_weight is not None:
        w = w * pixel_weight
    valid_cnt = all_reduce_sum(((unc <= threshold) & valid).sum(), group)
    return all_reduce_sum((w * nll).sum(), group) / (valid_cnt + EPS)


def prototype_contrastive_loss(prototypes: torch.Tensor, feat: torch.Tensor,
                               labels: torch.Tensor, temperature: float = 8.0,
                               ignore_label: int = -1,
                               group: Optional[DataGroup] = None) -> torch.Tensor:
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
    return all_reduce_sum(nll.sum(), group) / (all_reduce_sum(valid.sum(), group) + EPS)


def _row_mean(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The mean of x's rows (1, K) over the global batch."""
    if group is None:
        return x.mean(dim=0, keepdim=True)
    return all_reduce_sum(x.sum(dim=0, keepdim=True), group) / (x.shape[0] * group.size)


def _covariance(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Unbiased (K, K) covariance of x's rows over the global batch."""
    n = x.shape[0] * (1 if group is None else group.size)
    xm = _row_mean(x, group) - x
    return all_reduce_sum(xm.T @ xm, group) / (n - 1)


def coral_loss(source: torch.Tensor, target: torch.Tensor,
               is_sqrt: bool = False, group: Optional[DataGroup] = None) -> torch.Tensor:
    """Deep CORAL (regda/gast/coral.py:15-47). source/target (N, K); with a
    group, the global batch's covariances, each from its global mean."""
    d = source.shape[1]
    xc = _covariance(source, group)
    xct = _covariance(target, group)
    loss = torch.sum((xc - xct) * (xc - xct))
    if is_sqrt:
        loss = torch.sqrt(loss)
    return loss / (4.0 * d * d)


def mmd_loss(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Linear-kernel MMD (regda/gast/mmd.py:15-58, kernel_type='linear')."""
    delta = source.mean(dim=0) - target.mean(dim=0)
    return torch.dot(delta, delta)


def multi_head_loss(preds, labels: torch.Tensor, loss_fn, **kw) -> torch.Tensor:
    """loss_calc (utils/tools.py:240-260): each head resized to the labels'
    resolution (bilinear, align_corners) where it differs, the per-head
    losses averaged."""
    hw = tuple(labels.shape[-2:])
    total = 0.0
    for p in preds:
        if tuple(p.shape[1:3]) != hw:
            p = resize_bilinear_align_corners(p, hw)
        total = total + loss_fn(p, labels, **kw)
    return total / len(preds)
