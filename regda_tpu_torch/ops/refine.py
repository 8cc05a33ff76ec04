"""Multi-view pseudo-label refinement (MPC in the reference).

Counterpart of regda_tpu/ops/refine.py (reference: regda/gast/alignment.py
:194-265). Soft pseudo-labels are re-weighted by detached views and
renormalized: the prototype view (inverse Pearson distance of the stride-16
features to the prototypes), the prediction view (temperature softmax of
the heads) and, where superpixel ids are given, the superpixel view (the
per-superpixel maximum of the soft label), which no RegDA tool passes.

On the mesh's spatial axis (`group`) the maps are this rank's block of
rows, and the stride-16 views are resized from the whole image's rows
(`resize_rows` gathers the (B, h, w, C) weights, not the features).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from regda_tpu_torch.ops.prototypes import pearson_dist
from regda_tpu_torch.ops.resize import resize_rows
from regda_tpu_torch.parallel.mesh import DataGroup

EPS = 1e-7


def _norm_by_max(w: torch.Tensor) -> torch.Tensor:
    return w / (w.amax(dim=-1, keepdim=True) + EPS)


def prototype_weight(feat: torch.Tensor, prototypes: torch.Tensor,
                     out_hw: tuple[int, int],
                     group: Optional[DataGroup] = None) -> torch.Tensor:
    """(B, h, w, K) stride-16 features -> (B, H, W, C) prototype-view weight."""
    b, h, w, k = feat.shape
    simi = 1.0 / pearson_dist(feat.reshape(-1, k), prototypes)
    simi = resize_rows(simi.reshape(b, h, w, -1), out_hw, group)
    return _norm_by_max(torch.softmax(simi, dim=-1))


def prediction_weight(preds: Sequence[torch.Tensor], out_hw: tuple[int, int],
                      temp: float = 2.0, group: Optional[DataGroup] = None) -> torch.Tensor:
    """Per-head logits (B, h, w, C) -> (B, H, W, C) prediction-view weight."""
    ws = [torch.softmax(resize_rows(p, out_hw, group) / temp, dim=-1) for p in preds]
    return _norm_by_max(sum(ws) / len(ws))


def superpixel_weight(label_soft: torch.Tensor, sup_ids: torch.Tensor, num_sup: int,
                      temp: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Superpixel view (alignment.py:239-258): per image, the maximum of the
    soft label over each superpixel, per class, gathered back to its pixels,
    temperature-softmaxed and divided by its per-pixel max. Pixels whose id
    is the batch's largest (the edge-shrink fill id) are ignored.

    label_soft (B, H, W, C), sup_ids (B, H, W) int in [0, num_sup) ->
    (weight (B, H, W, C), ignored (B, H, W, 1) bool)."""
    b, h, w, c = label_soft.shape
    ids = sup_ids.reshape(b, h * w, 1).long().expand(b, h * w, c)
    flat = label_soft.reshape(b, h * w, c)
    seg_max = torch.full((b, num_sup, c), -math.inf, dtype=flat.dtype, device=flat.device)
    seg_max = seg_max.scatter_reduce(1, ids, flat, 'amax', include_self=False)
    prob_pixel = torch.gather(seg_max, 1, ids).reshape(b, h, w, c)
    wgt = _norm_by_max(torch.softmax(prob_pixel / temp, dim=-1))
    ignored = (sup_ids == sup_ids.max())[..., None]
    return wgt, ignored


def label_refine(feat: torch.Tensor, preds: Sequence[torch.Tensor],
                 label_soft: torch.Tensor, prototypes: torch.Tensor,
                 mode: str = 'all', temp: float = 2.0,
                 sup_ids: Optional[torch.Tensor] = None,
                 num_sup: Optional[int] = None,
                 group: Optional[DataGroup] = None) -> torch.Tensor:
    """Refine soft pseudo-labels (B, H, W, C); returns renormalized (B, H, W, C).
    The weights carry no gradient, as the reference's .detach(). The
    superpixel view applies where `sup_ids` (B, H, W) and the bound
    `num_sup` are given and the mode is 'all' or 's'; mode 's' without them
    returns `label_soft` as it is. With a process group (`group`) it is
    refused: its maxima are the batch's and the superpixels' of one
    process."""
    if mode not in ('all', 'p', 'l', 's'):
        raise ValueError(f'refine mode {mode!r}')
    if sup_ids is not None and group is not None:
        raise ValueError('label_refine: the superpixel view runs without a process group')
    out_hw = tuple(label_soft.shape[1:3])
    with torch.no_grad():
        weight = 0.0
        if mode in ('all', 'p'):
            weight = weight + prototype_weight(feat, prototypes, out_hw, group)
        if mode in ('all', 'l'):
            weight = weight + prediction_weight(preds, out_hw, temp, group)
        if sup_ids is not None and mode in ('all', 's'):
            if num_sup is None:
                raise ValueError('label_refine: pass num_sup with sup_ids')
            sup_w, ignored = superpixel_weight(label_soft, sup_ids, num_sup, temp)
            if mode == 'all':
                weight = torch.where(ignored, weight, weight * sup_w)
            else:
                weight = torch.where(ignored, torch.ones_like(sup_w), sup_w)
    if isinstance(weight, float):                    # mode had no views
        return label_soft
    refined = weight * label_soft
    return refined / (refined.sum(dim=-1, keepdim=True) + EPS)
