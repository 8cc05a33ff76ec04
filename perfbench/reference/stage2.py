"""Plain PyTorch reference of RegDA's stage-2 step (tools/train_align_reg.py
:144-196 of StuLiu/RegDA, with `--align-domain 1 --refine-label 1
--sam-refine`), written from the recipe and imported from nothing of the
program:

  source forward -> prototype EMA (16x majority-vote labels, decay 0.996)
  -> target forward -> soft labels (mean of both heads' softmaxes at the
  image's size) -> refinement (prototype view: softmax of the inverse
  Pearson distance; prediction view: softmax of the logits / temperature;
  each divided by its maximum, summed, times the soft label, renormalised)
  -> selection (the one class above max(0.8 x its image maximum, 0.6))
  -> LRH (each SAM region takes its majority class where that holds at
  least `percent` of its labelled pixels; region 0 abstains) -> 16x
  majority vote -> losses: cross-entropy of both heads at the labels' size
  (ignored pixels count 0 in the mean), Deep CORAL of the features, the
  prototype-contrastive loss of both domains' features (temperature 8)
  halved -> backward -> clip to global norm 32 -> SGD (momentum 0.9,
  weight decay 5e-4 on every parameter, poly learning rate after a linear
  warm-up of stop_steps / 20 steps).

NCHW throughout; the images come in as (B, H, W, 3) numpy, as the batch
does. The LRH histogram is `torch.bincount`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-7


def lr_at(count: int, base_lr: float, stop_steps: int, power: float) -> float:
    """Linear warm-up over stop_steps / 20 steps, then poly decay over
    1.5 x stop_steps (regda/utils/tools.py), in float32."""
    preheat = int(stop_steps / 20)
    s = np.float32(count)
    if s < preheat:
        return float(np.float32(base_lr) * s / np.float32(max(preheat, 1)))
    return float(np.float32(base_lr) * (np.float32(1) - s / np.float32(stop_steps * 1.5))
                 ** np.float32(power))


def downscale(label: torch.Tensor, s: int, num_classes: int, ignore: int,
              min_ratio: float = 0.75) -> torch.Tensor:
    """(B, H, W) -> (B, H/s, W/s): the window's most common value (ignored
    pixels vote too), ignored where that is the ignore label or holds less
    than `min_ratio` of the window."""
    b, h, w = label.shape
    lbl = torch.where(label == ignore, num_classes, label).long()
    votes = F.one_hot(lbl, num_classes + 1).float()
    share = votes.view(b, h // s, s, w // s, s, -1).mean(dim=(2, 4))
    top, arg = share.amax(-1), share.argmax(-1)
    out = torch.where((arg == num_classes) | (top < min_ratio), ignore, arg)
    return out.int()


def class_means(feat_rows: torch.Tensor, labels: torch.Tensor, num_classes: int,
                fallback: torch.Tensor) -> torch.Tensor:
    """Per-class mean of the feature rows under `labels` (rows of ignored
    labels count nowhere); a class with no row keeps `fallback`."""
    onehot = F.one_hot(torch.where(labels < 0, num_classes, labels).long(),
                       num_classes + 1)[:, :num_classes].float()
    counts = onehot.sum(0)[:, None]
    means = onehot.T @ feat_rows / (counts + EPS)
    return torch.where(counts < 1, fallback, means)


def pearson_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, K), (M, K) -> (N, M): (1 - Pearson correlation) / 2."""
    k = a.shape[1]
    cov = (a - a.mean(1, keepdim=True)) @ (b - b.mean(1, keepdim=True)).T / (k - 1 + EPS)
    return (1.0 - cov / (a.std(1)[:, None] * b.std(1)[None, :] + EPS)) * 0.5


def up(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, hw, mode='bilinear', align_corners=True)


def lrh(hard: torch.Tensor, regions: torch.Tensor, percent: float, num_classes: int,
        ignore: int, num_regions: int = 1024) -> torch.Tensor:
    """Local region homogenizing of (B, H, W) labels over region ids."""
    out = hard.clone()
    for i in range(hard.shape[0]):
        lab, reg = hard[i].reshape(-1).long(), regions[i].reshape(-1).long()
        reg = torch.where((reg >= 0) & (reg < num_regions), reg, 0)
        ok = (lab >= 0) & (lab < num_classes)
        hist = torch.bincount(reg[ok] * num_classes + lab[ok],
                              minlength=num_regions * num_classes)
        hist = hist.view(num_regions, num_classes).float()
        top, cls = hist.amax(1), hist.argmax(1)
        share = top / (hist.sum(1) + 1e-5)
        region_cls = torch.where(share < percent, ignore, cls)
        voted = region_cls[reg]
        voted = torch.where(reg == 0, ignore, voted)
        out[i] = torch.where(voted == ignore, lab, voted).view(hard.shape[1:]).to(out.dtype)
    return out


def contrastive(protos: torch.Tensor, feat_rows: torch.Tensor, labels: torch.Tensor,
                temp: float, ignore: int) -> torch.Tensor:
    """Cross-entropy over the cosine similarities to the prototypes / temp,
    averaged over the labelled rows."""
    f = feat_rows / (feat_rows.norm(dim=1, keepdim=True) + 1e-12)
    p = protos / (protos.norm(dim=1, keepdim=True) + 1e-12)
    valid = labels != ignore
    nll = F.cross_entropy(f @ p.T / temp, torch.where(valid, labels, 0).long(),
                          reduction='none')
    return (nll * valid).sum() / (valid.sum() + EPS)


def coral(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.shape[1]

    def cov(x):
        xm = x.mean(0, keepdim=True) - x
        return xm.T @ xm / (x.shape[0] - 1)

    diff = cov(a) - cov(b)
    return (diff * diff).sum() / (4.0 * d * d)


def rows(feat: torch.Tensor) -> torch.Tensor:
    return feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1])


class Stage2:
    """The step's state: a reference model, its momentum buffers, the
    prototypes and the optimizer's update count."""

    def __init__(self, model, prototypes: torch.Tensor, recipe: dict, num_classes: int,
                 generator: torch.Generator):
        self.model, self.protos = model, prototypes
        self.r, self.c, self.g = recipe, num_classes, generator
        self.params = [p for p in model.parameters()]
        self.momentum = [None] * len(self.params)
        self.count = 0
        self.clipped_grads = None

    def step(self, images_s, label_s, images_t, regs_t) -> float:
        r, c, ignore = self.r, self.c, self.r['ignore_label']
        dev = self.protos.device
        x_s = torch.from_numpy(images_s).to(dev).permute(0, 3, 1, 2)
        x_t = torch.from_numpy(images_t).to(dev).permute(0, 3, 1, 2)
        y_s = torch.from_numpy(label_s).to(dev)
        regs = torch.from_numpy(regs_t).to(dev)
        hw = tuple(y_s.shape[1:])
        model = self.model.train()

        p_s1, p_s2, f_s = model(x_s, self.g)
        with torch.no_grad():
            ys_down = downscale(y_s, 16, c, ignore)
            protos = (1 - r['proto_decay']) * class_means(
                rows(f_s), ys_down.reshape(-1), c, self.protos) + r['proto_decay'] * self.protos
        p_t1, p_t2, f_t = model(x_t, self.g)
        with torch.no_grad():
            u1, u2 = up(p_t1, hw), up(p_t2, hw)
            soft = (u1.softmax(1) + u2.softmax(1)) / 2
            if r['refine_label']:
                b, k, h, w = f_t.shape
                simi = 1.0 / pearson_distance(rows(f_t), protos)
                simi = simi.view(b, h, w, c).permute(0, 3, 1, 2)
                w_proto = up(simi, hw).softmax(1)
                w_proto = w_proto / (w_proto.amax(1, keepdim=True) + EPS)
                w_pred = ((u1 / r['refine_temp']).softmax(1)
                          + (u2 / r['refine_temp']).softmax(1)) / 2
                w_pred = w_pred / (w_pred.amax(1, keepdim=True) + EPS)
                soft = (w_proto + w_pred) * soft
                soft = soft / (soft.sum(1, keepdim=True) + EPS)
            peak = soft.amax(dim=(2, 3), keepdim=True)
            passed = soft > torch.clamp(peak * r['cutoff_top'], min=r['cutoff_low'])
            hard = torch.where(passed.sum(1) == 1, passed.int().argmax(1), ignore)
            if r['sam_refine']:
                hard = lrh(hard, regs, r['percent'], c, ignore)
            yt_down = downscale(hard, 16, c, ignore)

        loss_seg = sum(F.cross_entropy(up(p, hw), y_s.long(), ignore_index=ignore,
                                       reduction='none').mean() for p in (p_s1, p_s2)) / 2
        loss_domain = coral(rows(f_s), rows(f_t)) if r['align_domain'] else 0.0
        loss_align = 0.5 * (contrastive(protos, rows(f_s), ys_down.reshape(-1),
                                        r['pcl_temp'], ignore)
                            + contrastive(protos, rows(f_t), yt_down.reshape(-1),
                                          r['pcl_temp'], ignore))
        loss = loss_seg + loss_domain + loss_align

        for p in self.params:
            p.grad = None
        loss.backward()
        self._sgd()
        self.protos = protos
        return float(loss.detach())

    @torch.no_grad()
    def _sgd(self) -> None:
        r = self.r
        grads = [p.grad for p in self.params]
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        scale = 1.0 if norm < r['clip_norm'] else r['clip_norm'] / norm
        lr = lr_at(self.count, r['lr'], r['stop_steps'], r['power'])
        self.clipped_grads = [g * scale for g in grads]
        for i, (p, g) in enumerate(zip(self.params, self.clipped_grads)):
            d = g + r['weight_decay'] * p
            self.momentum[i] = d.clone() if self.momentum[i] is None else \
                self.momentum[i] * r['momentum'] + d
            p -= lr * self.momentum[i]
        self.count += 1
