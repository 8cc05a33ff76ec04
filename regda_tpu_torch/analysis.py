"""Offline pseudo-label quality diagnostics (counterpart of
regda_tpu/analysis.py; reference: regda/gast/pseudo_generation.py:158-300,
regda/utils/classvis.py:24-98).

Pixels of each tile are bucketed by prediction entropy into `range_cnt`
bins spanning [0, log(C)); per bin: how many selected pseudo-labels fall
there and how many are right, and the mean difficulty 1 - p_gt. One pass a
tile on the device (`tile_bin_stats`); the reference loops its 100 bins in
Python. The entropy and the per-bin sums are float64, so a pixel's bin and
the counts do not depend on the device's rounding: float32 entropies of two
devices differ in their last bit, which moves a pixel lying within that bit
of a bin edge into the next bin (the JAX package computes in float32, so
such a pixel may sit one bin over there).

The plots are written as PNGs (matplotlib, imported by the plot calls
only); the statistics need no plotting (`out_dir=None`).
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import torch
from PIL import Image

from regda_tpu_torch.entry import _device
from regda_tpu_torch.ops.labels import one_hot_ignore
from regda_tpu_torch.ops.pseudo import pseudo_selection

EPS = 1e-7
STAT_KEYS = ('cnt_true', 'cnt_used', 'acc', 'diffi', 'acc_valid', 'diffi_valid')


def tile_bin_stats(probs: torch.Tensor, gt: torch.Tensor, n_classes: int,
                   range_cnt: int = 100, cutoff_top: float = 0.8,
                   cutoff_low: float = 0.6) -> dict[str, torch.Tensor]:
    """Per-entropy-bin statistics of one tile, on the tensors' device.

    probs (H, W, C) softmax probabilities (a saved `.npy` pseudo map), gt
    (H, W) ground-truth ids (< 0 ignored) -> dict of (range_cnt,) float64
    tensors: cnt_true, cnt_used, acc, diffi, and the masks acc_valid /
    diffi_valid of the reference's conditional bin averaging
    (pseudo_generation.py:203-207)."""
    step = math.log(n_classes) / range_cnt
    pseudo = pseudo_selection(probs[None], cutoff_top, cutoff_low)[0]
    p = probs.double()
    entropy = -(p * torch.log(p.clamp(min=EPS))).sum(-1)
    difficulty = 1.0 - (p * one_hot_ignore(gt, n_classes, dtype=torch.float64)).sum(-1)
    bins = (entropy / step).long().clamp(0, range_cnt - 1).reshape(-1)

    def seg(v):
        out = torch.zeros(range_cnt, dtype=torch.float64, device=probs.device)
        return out.index_add_(0, bins, v.reshape(-1).double())

    used = pseudo >= 0
    cnt_used = seg(used)
    cnt_true = seg((pseudo == gt) & used)
    in_bin = seg(torch.ones_like(used))
    diffi = seg(difficulty) / (in_bin + EPS)
    return dict(cnt_true=cnt_true, cnt_used=cnt_used, acc=cnt_true / (cnt_used + EPS),
                diffi=diffi, acc_valid=(cnt_used > 0).double(), diffi_valid=(diffi > 0).double())


def _read_png(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def analysis_pseudo_labels(label_dir: str, pseudo_dir: str, n_classes: int = 6,
                           range_cnt: int = 100, out_dir: str | None = None,
                           label_offset: int = 0, device='cuda') -> dict:
    """Sweep the (ground-truth `*.png`, saved probabilities `*.npy`) pairs of
    two directories in name order, aggregate `tile_bin_stats` computed on
    `device` (the card unless the caller names another), and, with
    `out_dir`, write the trade-off, noise-rate and count plots
    (pseudo_generation.py:158-221). -> dict of numpy arrays: x (the bins'
    entropies), acc, diffi, cnt_true, cnt_used."""
    device = _device(device)
    labels = sorted(glob.glob(os.path.join(label_dir, '*.png')))
    pseudos = sorted(glob.glob(os.path.join(pseudo_dir, '*.npy')))
    if len(labels) != len(pseudos):
        raise ValueError(f'{len(labels)} label tiles against {len(pseudos)} pseudo maps')
    agg = {k: torch.zeros(range_cnt, dtype=torch.float64, device=device) for k in STAT_KEYS}
    for lbl_path, prob_path in zip(labels, pseudos):
        gt = _read_png(lbl_path).astype(np.int32) + label_offset
        gt = np.where(gt >= n_classes, -1, gt)
        stats = tile_bin_stats(torch.from_numpy(np.load(prob_path)).to(device),
                               torch.from_numpy(gt).to(device), n_classes, range_cnt)
        for k in agg:
            agg[k] += stats[k]
    agg = {k: v.cpu().numpy() for k, v in agg.items()}
    acc = agg['acc'] / (agg['acc_valid'] + EPS)
    diffi = agg['diffi'] / (agg['diffi_valid'] + EPS)
    x = np.arange(range_cnt) * (math.log(n_classes) / range_cnt)
    result = dict(x=x, acc=acc, diffi=diffi, cnt_true=agg['cnt_true'],
                  cnt_used=agg['cnt_used'])
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        half = range_cnt // 2
        show_tradeoff(x[:half], diffi[:half], agg['cnt_used'][:half],
                      os.path.join(out_dir, 'tradeoff.png'))
        plot_noise_rate(x, acc, diffi, os.path.join(out_dir, 'noise_rate.png'))
        plot_cnt(x, agg['cnt_true'], agg['cnt_used'], os.path.join(out_dir, 'counts.png'))
    return result


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def show_tradeoff(x, difficulty, cnt_used, save_path: str) -> None:
    """Difficulty against usable-pixel count on twin axes
    (pseudo_generation.py `show_tradeoff`)."""
    plt = _plt()
    fig, ax1 = plt.subplots()
    ax1.plot(x, difficulty, 'r-', label='difficulty')
    ax1.set_xlabel('entropy')
    ax1.set_ylabel('difficulty', color='r')
    ax2 = ax1.twinx()
    ax2.plot(x, cnt_used, 'b-', label='used pixels')
    ax2.set_ylabel('count', color='b')
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)


def plot_noise_rate(x, acc, diffi, save_path: str) -> None:
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(x, 1.0 - np.asarray(acc), label='noise rate (1 - acc)')
    ax.plot(x, diffi, label='difficulty')
    ax.set_xlabel('entropy')
    ax.legend()
    fig.savefig(save_path)
    plt.close(fig)


def plot_cnt(x, cnt_true, cnt_used, save_path: str) -> None:
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(x, cnt_true, label='correct')
    ax.plot(x, cnt_used, label='used')
    ax.set_xlabel('entropy')
    ax.set_ylabel('pixels')
    ax.legend()
    fig.savefig(save_path)
    plt.close(fig)


def class_distribution(mask_dir: str, class_num: int, offset: int = 0) -> np.ndarray:
    """Mean per-class pixel ratio over a tree of mask PNGs (classvis.py:24-37)."""
    rates = np.zeros(class_num, np.float64)
    for p in sorted(glob.glob(os.path.join(mask_dir, '*.png'))):
        mask = _read_png(p).astype(np.int64) + offset
        hist = np.bincount(mask[(mask >= 0) & (mask < class_num)].ravel(), minlength=class_num)
        rates += hist / mask.size
    return (rates / max(rates.sum(), EPS)).astype(np.float32)


def da_class_bar(dir1: str, dir2: str, class_names, save_path: str,
                 names=('source', 'target'), offset: int = 0, max_rate: float = 0.5):
    """Side-by-side horizontal class-frequency bars of two domains
    (classvis.py:40-98), saved to `save_path`; -> the two distributions."""
    c = len(class_names)
    v1 = class_distribution(dir1, c, offset)
    v2 = class_distribution(dir2, c, offset)
    plt = _plt()
    fig, ax = plt.subplots()
    y = np.arange(c)
    width = 0.4
    ax.barh(y, v1, height=width, label=names[0])
    ax.barh(y + width, v2, height=width, label=names[1])
    ax.set_yticks(y + width / 2, class_names)
    ax.set_xlim(0, max_rate)
    ax.set_xlabel('ratio')
    ax.set_ylabel('class')
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return v1, v2
