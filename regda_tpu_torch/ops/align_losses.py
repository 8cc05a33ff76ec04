"""Prototype and instance alignment losses and whitening regularisers
(counterpart of regda_tpu/ops/align_losses.py).

References (the reference's GAST lineage, which no regda tool calls):
class_align_loss / instance_align_loss, regda/gast/alignment.py:329-394
(margin loss, hardest negatives over Pearson distances); SAW, regda/gast/
SAW.py:16-120; PixelContrastLoss, regda/gast/contrastive.py:27-163;
TripletLoss, regda/gast/triple.py:13-56; MSCLoss, regda/gast/MSCLoss.py
:14-125; CategoryAlign_Module / ICR / CCR / MSE, regda/dca_modules.py:14-189.

As in the JAX package the reference's loops are batched tensor algebra: the
pixel-contrast anchors are static (B * C, n_view) slots chosen by a top-k
over a random priority that prefers hard anchors, with slots of too few
pixels masked out; MSC's votes are top-k and one-hot sums. The random
priority is drawn apart (`pixel_contrast_priority`, from an explicit
`torch.Generator`) from the body that takes it. Top-k and argsort return
values in the JAX order; where the indices matter (the anchors, the MSC
votes, SAW's channel order), tied inputs may pick other members of a tie
than JAX does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.labels import one_hot_ignore
from regda_tpu_torch.ops.prototypes import pearson_dist

EPS = 1e-7


# ---------------------------------------------------- margin alignment losses
def class_align_loss(prototypes_1: torch.Tensor, prototypes_2: torch.Tensor,
                     margin: float = 0.3, hard_ratio: float = 0.3) -> torch.Tensor:
    """Margin loss between two (C, K) local prototype sets, hardest negatives
    mined over the Pearson-distance matrix."""
    c = prototypes_1.shape[0]
    dist = pearson_dist(prototypes_1, prototypes_2)                       # (C, C)
    hard_num = min(math.ceil(hard_ratio * c), c - 1)
    eye_neg = 1.0 - torch.eye(c, dtype=dist.dtype, device=dist.device)
    # the hard_num + 1 smallest of dist * eye_neg: slot 0 is the zeroed diagonal
    neg = torch.topk(dist * eye_neg, hard_num + 1, dim=1, largest=False).values[:, 1:]
    pos = torch.diagonal(dist)[:, None]
    return torch.clamp(pos - neg + margin, min=1e-6).mean()


def instance_align_loss(feat: torch.Tensor, label: torch.Tensor, prototypes: torch.Tensor,
                        margin: float = 0.3, hard_ratio: float = 0.3) -> torch.Tensor:
    """Margin loss between per-pixel features (B, h, w, K) and (C, K)
    prototypes; labels (B, h, w), < 0 ignored."""
    c, k = prototypes.shape
    flat = feat.reshape(-1, k)
    lab = label.reshape(-1)
    valid = (lab >= 0).to(flat.dtype)[:, None]
    mask_pos = one_hot_ignore(lab, c).to(flat.dtype)
    dist = pearson_dist(flat, prototypes)                                 # (N, C)
    hard_num = min(math.ceil(hard_ratio * c) + 1, c)
    neg = torch.topk(dist * (1.0 - mask_pos), hard_num, dim=1, largest=False).values[:, 1:]
    pos = (dist * mask_pos).sum(dim=1, keepdim=True)
    loss = torch.clamp(pos - neg + margin, min=1e-6) * valid
    return loss.sum() / (valid.sum() * (hard_num - 1) + EPS)


# ----------------------------------------------- SAW (semantic-aware whitening)
def saw_loss(feats: torch.Tensor, classifier_weights: torch.Tensor,
             selected_classes: Sequence[int], relax_denom: float = 2.0) -> torch.Tensor:
    """Group-whitening penalty on classifier-sorted channel groups.
    feats (B, H, W, K), classifier_weights (C_cls, K); len(selected_classes)
    in {2, 4, 6, 8, 16}, as the reference asserts."""
    sel = torch.as_tensor(list(selected_classes), device=feats.device)
    n_sel = int(sel.shape[0])
    if n_sel not in (2, 4, 6, 8, 16):
        raise ValueError(f'{n_sel} selected classes: the reference takes 2, 4, 6, 8 or 16')
    b, h, w, k = feats.shape
    n_groups = k // n_sel
    w_abs = classifier_weights.abs()
    order = torch.argsort(-w_abs, dim=1, stable=True)
    gate = torch.sigmoid(w_abs)
    ch = order[sel, :n_groups]                                           # (n_sel, G)
    wg = torch.gather(gate[sel], 1, ch)                                  # (n_sel, G)
    x = feats.reshape(b, h * w, k)
    grouped = x[:, :, ch.T] * wg.T[None, None]                           # (B, HW, G, n_sel)
    grouped = grouped.permute(2, 0, 3, 1)                                # (G, B, n_sel, HW)
    eye = torch.eye(n_sel, dtype=feats.dtype, device=feats.device)
    off_mask = torch.triu(torch.ones(n_sel, n_sel, dtype=feats.dtype, device=feats.device), 1)
    num_off = off_mask.sum()
    margin = torch.floor(num_off / relax_denom) if relax_denom else 0.0
    cov = grouped @ grouped.transpose(-1, -2) / (h * w - 1) + 1e-5 * eye  # (G, B, s, s)
    off = (cov * off_mask).abs().sum(dim=(-1, -2)) - margin              # (G, B)
    return (torch.clamp(off / num_off, min=0.0).sum(dim=1) / b).sum()


# ------------------------------------------------------- pixel contrastive loss
def pixel_contrast_priority(generator: Optional[torch.Generator], batch: int,
                            num_classes: int, pixels: int, device=None) -> torch.Tensor:
    """The anchors' random priority: (B, C, h * w) uniform in [0, 1)."""
    return torch.rand((batch, num_classes, pixels), generator=generator).to(device)


def pixel_contrast_loss_body(u: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor,
                             predict: torch.Tensor, num_classes: int,
                             max_samples: int = 1024, max_views: int = 100,
                             temperature: float = 0.1,
                             base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised InfoNCE over hard-mined pixel anchors, given the priority
    `u` (B, C, h * w). feats (B, h, w, K); labels (B, h, w) ids at feature
    resolution (< 0 ignored), the anchors' classes; predict (B, h, w) ids,
    the hardness reference. A (image, class) slot with more than max_views
    pixels of its class draws n_view of them, hard ones (predict != label)
    first; the other slots are masked out."""
    b, h, w, k = feats.shape
    n_slots = b * num_classes
    n_view = min(max(max_samples // max(n_slots, 1), 1), max_views)
    flat_f = feats.reshape(b, h * w, k)
    flat_y = labels.reshape(b, h * w)
    flat_p = predict.reshape(b, h * w)
    cls_ids = torch.arange(num_classes, device=feats.device)
    is_cls = flat_y[:, None, :] == cls_ids[None, :, None]                # (B, C, HW)
    slot_valid = (is_cls.sum(-1) > max_views).reshape(n_slots)
    hard = is_cls & (flat_p[:, None, :] != cls_ids[None, :, None])
    prio = torch.where(is_cls, u + hard.to(u.dtype), -math.inf)
    idx = torch.topk(prio, n_view, dim=-1).indices                       # (B, C, n_view)
    anchors = torch.gather(flat_f[:, None].expand(b, num_classes, h * w, k), 2,
                           idx[..., None].expand(b, num_classes, n_view, k))
    anchors = anchors.reshape(n_slots, n_view, k)
    slot_y = cls_ids[None].expand(b, num_classes).reshape(n_slots)
    cf = anchors.transpose(0, 1).reshape(n_slots * n_view, k)
    vy = slot_y.repeat(n_view)
    vv = slot_valid.repeat(n_view)
    logits = (cf @ cf.T) / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    both = vv[:, None] & vv[None, :]
    pos_mask = (vy[:, None] == vy[None, :]) & both
    pos_mask = pos_mask & ~torch.eye(len(vy), dtype=torch.bool, device=feats.device)
    neg_mask = (vy[:, None] != vy[None, :]) & both
    neg_sum = (torch.exp(logits) * neg_mask).sum(1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits) + neg_sum + EPS)
    mean_log_prob_pos = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1) + EPS)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return (loss * vv).sum() / (vv.sum() + EPS)


def pixel_contrast_loss(generator: Optional[torch.Generator], feats: torch.Tensor,
                        labels: torch.Tensor, predict: torch.Tensor, num_classes: int,
                        **kw) -> torch.Tensor:
    """`pixel_contrast_loss_body` on a priority drawn from `generator`."""
    b, h, w, _ = feats.shape
    u = pixel_contrast_priority(generator, b, num_classes, h * w, feats.device)
    return pixel_contrast_loss_body(u.to(feats.dtype), feats, labels, predict,
                                    num_classes, **kw)


# ----------------------------------------------------------------- triplet loss
def triplet_loss(inputs: torch.Tensor, targets: torch.Tensor,
                 margin: float = 0.3) -> torch.Tensor:
    """Batch-hard triplet margin loss on (N, K) embeddings."""
    sq = (inputs ** 2).sum(dim=1)
    dist = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * inputs @ inputs.T,
                                  min=1e-12))
    same = targets[:, None] == targets[None, :]
    d_ap = torch.where(same, dist, -math.inf).amax(dim=1)
    d_an = torch.where(same, math.inf, dist).amin(dim=1)
    return torch.clamp(margin + d_ap - d_an, min=0.0).mean()


# --------------------------------------------------------------------- MSC loss
def msc_loss(src_features: torch.Tensor, src_labels: torch.Tensor,
             tgt_features: torch.Tensor, num_classes: int, k: int = 3, m: int = 3,
             mu: int = 8) -> torch.Tensor:
    """kNN-vote target pseudo-labels, a similarity-ratio confidence filter,
    and a same/different-class softmax contrast over inverse-distance
    similarities. src (Ns, K) with labels (Ns,), tgt (Nt, K); k votes a
    target, m similarities in the ratio, mu confident targets kept."""
    sim = 1.0 / (torch.linalg.vector_norm(src_features[:, None] - tgt_features[None],
                                          dim=-1) + 1.0)                  # (Ns, Nt)
    nn_idx = torch.topk(sim.T, k, dim=1).indices                          # (Nt, k)
    votes = one_hot_ignore(src_labels[nn_idx], num_classes).sum(1)
    tgt_labels = votes.argmax(-1)
    same_cls = src_labels[:, None] == tgt_labels[None, :]
    nln_top = torch.topk(torch.where(same_cls, sim, -math.inf).T, m, dim=1).values
    nun_top = torch.topk(torch.where(same_cls, -math.inf, sim).T, m, dim=1).values
    nln_top = torch.where(torch.isfinite(nln_top), nln_top, 0.0)
    nun_top = torch.where(torch.isfinite(nun_top), nun_top, 0.0)
    conf = nln_top.sum(1) / (nun_top.sum(1) + EPS)
    keep = torch.topk(conf, mu).indices
    f_sim, f_lab = sim[:, keep], tgt_labels[keep]
    mask_sim = (src_labels[:, None] == f_lab[None, :]).to(sim.dtype)
    row_ok = (mask_sim.sum(1) > 0) & ((1.0 - mask_sim).sum(1) > 0)
    contrast = (torch.softmax(f_sim, dim=1) * mask_sim).sum(1)
    logs = torch.where(row_ok, torch.log(torch.clamp(contrast, min=EPS)), 0.0)
    return -logs.sum() / (row_ok.sum() + EPS)


# ------------------------------------------------------ category-context losses
def category_context(preds: torch.Tensor, feats: torch.Tensor,
                     ignore_bg: bool = False) -> torch.Tensor:
    """Per-class context vectors, probability-weighted feature means, L2
    normalised over the class axis (F.normalize(dim=1), dca_modules.py:33).
    preds (B, h, w, C) probabilities, feats (B, h, w, K) -> (B, C[-1], K)."""
    num = torch.einsum('bhwc,bhwk->bck', preds, feats)
    vectors = num / (preds.sum(dim=(1, 2))[..., None] + EPS)
    if ignore_bg:
        vectors = vectors[:, 1:, :]
    return vectors / (torch.linalg.vector_norm(vectors, dim=1, keepdim=True) + 1e-12)


def _pearson_corr_mat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ac = a - a.mean(dim=1, keepdim=True)
    bc = b - b.mean(dim=1, keepdim=True)
    ac = ac / (torch.linalg.vector_norm(ac, dim=1, keepdim=True) + 1e-12)
    bc = bc / (torch.linalg.vector_norm(bc, dim=1, keepdim=True) + 1e-12)
    return ac @ bc.T


def _regularize_cor(cor: torch.Tensor) -> torch.Tensor:
    n = cor.shape[0]
    pos = -torch.log(torch.clamp(torch.diagonal(cor), min=EPS)).mean()
    off = cor[~torch.eye(n, dtype=torch.bool, device=cor.device)]
    neg = -torch.log(1.0 - torch.clamp(off, min=1e-6)).mean()
    return pos + neg


def _mean_probs(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(p1, -1) + torch.softmax(p2, -1)) / 2


def icr_loss(preds1: torch.Tensor, preds2: torch.Tensor, feats: torch.Tensor,
             num_classes: int, ignore_bg: bool = True) -> torch.Tensor:
    """Intra-domain covariance regularisation: the batch's two halves' class
    contexts correlated (dca_modules.py:80-106)."""
    probs = _mean_probs(preds1, preds2).detach()
    half = probs.shape[0] // 2
    c1 = category_context(probs[:half], feats[:half], ignore_bg).mean(0)
    c2 = category_context(probs[half:], feats[half:], ignore_bg).mean(0)
    return _regularize_cor(_pearson_corr_mat(c1, c2))


def ccr_loss(source, target, num_classes: int, ignore_bg: bool = True) -> torch.Tensor:
    """Cross-domain covariance regularisation, the source side detached
    (dca_modules.py:109-134). source, target: (pred1, pred2, feats)."""
    s_p1, s_p2, s_f = source
    t_p1, t_p2, t_f = target
    c_s = category_context(_mean_probs(s_p1, s_p2).detach(), s_f.detach(), ignore_bg).mean(0)
    c_t = category_context(_mean_probs(t_p1, t_p2), t_f, ignore_bg).mean(0)
    return _regularize_cor(_pearson_corr_mat(c_s, c_t))


def mse_context_loss(source, target, ignore_bg: bool = True) -> torch.Tensor:
    """MSE between the domains' class contexts, the source detached
    (dca_modules.py:137-189, the cross-domain form)."""
    s_p1, s_p2, s_f = source
    t_p1, t_p2, t_f = target
    c_s = category_context(_mean_probs(s_p1, s_p2).detach(), s_f.detach(), ignore_bg)
    c_t = category_context(_mean_probs(t_p1, t_p2), t_f, ignore_bg)
    return torch.mean((c_s - c_t) ** 2)
