"""Batch-mixing augmentations: ClassMix, CutMix and Mixup (counterpart of
regda_tpu/ops/mix.py).

References (helpers that no regda tool calls): regda/utils/classmix.py
:17-53 (classmix), regda/utils/cutmix.py:15-53 (cutmix, cutmix2),
regda/utils/tools.py:155-170 (mixup).

Each mix is two functions: a draw from an explicit `torch.Generator` (a
class permutation, a Beta lambda, a box centre, a batch permutation) and a
deterministic body that takes the draws, so that the body can be held to
the JAX package's on the JAX draws. A `torch.Generator` cannot reproduce
JAX's random bits; the draws are held by what they must satisfy. Every mix
is a mask select, as in the JAX package. Images (B, H, W, C), labels
(B, H, W).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _uniform(generator: Optional[torch.Generator], n: int = 1) -> torch.Tensor:
    return torch.rand(n, generator=generator, dtype=torch.float64)


def beta_draw(generator: Optional[torch.Generator], alpha: float, beta: float) -> float:
    """One Beta(alpha, beta) draw from `generator` by Johnk's method: with
    u, v uniform, x = u^(1/alpha), y = v^(1/beta), accepted where x + y <= 1,
    x / (x + y) is Beta distributed (torch's Beta takes no generator)."""
    while True:
        u, v = _uniform(generator, 2).tolist()
        x, y = u ** (1.0 / alpha), v ** (1.0 / beta)
        if 0.0 < x + y <= 1.0:
            return x / (x + y)


# ------------------------------------------------------------------ classmix
def classmix_draw(generator: Optional[torch.Generator], class_num: int = 7,
                  ratio: float = 0.5) -> torch.Tensor:
    """(class_num,) bool: int(class_num * ratio) classes chosen by a random
    permutation."""
    perm = torch.randperm(class_num, generator=generator)
    chosen = torch.zeros(class_num, dtype=torch.bool)
    chosen[perm[:int(class_num * ratio)]] = True
    return chosen


def classmix_apply(chosen: torch.Tensor, data_s, targets_s, data_t, targets_t,
                   ignore_label: int = -1):
    """Paste the source pixels of the chosen classes onto the target batch
    -> (data_s, targets_s, data_t_mixed, targets_t_mixed)."""
    class_num = chosen.shape[0]
    chosen = chosen.to(targets_s.device)
    valid = (targets_s >= 0) & (targets_s != ignore_label)
    cond = valid & chosen[torch.clamp(targets_s, 0, class_num - 1).long()]
    targets_t = torch.where(cond, targets_s, targets_t)
    data_t = torch.where(cond[..., None], data_s, data_t)
    return data_s, targets_s, data_t, targets_t


def classmix(generator, data_s, targets_s, data_t, targets_t, ratio: float = 0.5,
             class_num: int = 7, ignore_label: int = -1):
    """Paste a random half of the source classes onto the target batch."""
    return classmix_apply(classmix_draw(generator, class_num, ratio), data_s, targets_s,
                          data_t, targets_t, ignore_label)


# -------------------------------------------------------------------- cutmix
def box_draw(generator: Optional[torch.Generator], h: int, w: int,
             alpha: float = 1.0) -> tuple[float, float, float]:
    """(lam, cx, cy): lam ~ Beta(alpha, alpha), a centre uniform over the
    image."""
    lam = beta_draw(generator, alpha, alpha)
    cx, cy = _uniform(generator, 2).tolist()
    return lam, cx * w, cy * h


def box_mask(h: int, w: int, lam: float, cx: float, cy: float,
             device=None) -> torch.Tensor:
    """(H, W) bool: the box of sides sqrt(1 - lam) * (H, W) around (cx, cy),
    its edges rounded, clipped by the image, computed in float32 as the JAX
    package computes it."""
    lam, cx, cy = (torch.tensor(v, dtype=torch.float32) for v in (lam, cx, cy))
    bw, bh = w * torch.sqrt(1.0 - lam), h * torch.sqrt(1.0 - lam)
    x0, x1 = torch.round(cx - bw / 2), torch.round(cx + bw / 2)
    y0, y1 = torch.round(cy - bh / 2), torch.round(cy + bh / 2)
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    xs = torch.arange(w, dtype=torch.float32)[None, :]
    return ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)).to(device)


def cutmix_apply(box: torch.Tensor, data_s, targets_s, data_t, targets_t):
    """Paste the source box onto every target image."""
    data_t = torch.where(box[None, :, :, None], data_s, data_t)
    targets_t = torch.where(box[None], targets_s, targets_t)
    return data_s, targets_s, data_t, targets_t


def cutmix(generator, data_s, targets_s, data_t, targets_t, alpha: float = 1.0):
    """Paste one shared random source box onto every target image."""
    h, w = data_s.shape[1:3]
    box = box_mask(h, w, *box_draw(generator, h, w, alpha), device=data_s.device)
    return cutmix_apply(box, data_s, targets_s, data_t, targets_t)


def cutmix2_apply(idx: torch.Tensor, box: torch.Tensor, data, targets):
    """In-batch CutMix: the box of image idx[i] pasted onto image i."""
    idx = idx.to(data.device)
    data = torch.where(box[None, :, :, None], data[idx], data)
    targets = torch.where(box[None], targets[idx], targets)
    return data, targets


def cutmix2(generator, data, targets, alpha: float = 1.0):
    """In-batch CutMix: paste a box from a shuffled copy of the batch."""
    idx = torch.randperm(data.shape[0], generator=generator)
    h, w = data.shape[1:3]
    box = box_mask(h, w, *box_draw(generator, h, w, alpha), device=data.device)
    return cutmix2_apply(idx, box, data, targets)


# --------------------------------------------------------------------- mixup
def mixup_apply(idx: torch.Tensor, lam: float, s_img, s_lab, t_img, t_lab):
    """Row-cut mixup: the top floor(lam * H) rows of the source batch and of
    the target batch permuted by idx change places (hard labels)."""
    h = s_img.shape[1]
    lam_rows = math.floor(float(torch.tensor(lam, dtype=torch.float32) * h))
    top = (torch.arange(h, device=s_img.device) < lam_rows)[:, None]     # (H, 1)
    idx = idx.to(t_img.device)
    t_img_p, t_lab_p = t_img[idx], t_lab[idx]
    new_s_img = torch.where(top[None, :, :, None], s_img, t_img_p)
    new_s_lab = torch.where(top[None], s_lab, t_lab_p)
    new_t_img = torch.where(top[None, :, :, None], t_img_p, s_img)
    new_t_lab = torch.where(top[None], t_lab_p, s_lab)
    return new_s_img, new_s_lab, new_t_img, new_t_lab


def mixup(generator, s_img, s_lab, t_img, t_lab, alpha: float = 0.2):
    """Swap the top lam-fraction of rows between the source batch and a
    shuffled target batch, lam ~ Beta(alpha, alpha)."""
    idx = torch.randperm(t_img.shape[0], generator=generator)
    return mixup_apply(idx, beta_draw(generator, alpha, alpha), s_img, s_lab, t_img, t_lab)
