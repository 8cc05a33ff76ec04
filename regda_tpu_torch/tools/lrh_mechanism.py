"""Measure what LRH does to pseudo-label quality, against ground truth.

The port's counterpart of tools/lrh_mechanism.py, with the same flags and
`--device`. It runs the stage-2 pseudo-label pipeline (dual-head soft label
-> optional prototype/prediction refine -> pseudo_selection -> homogenize,
the train_align_reg.py:166-182 order) on the target train tiles with a
trained checkpoint, and scores its labels before and after LRH against the
ground truth that training never sees: label coverage, accuracy on labeled
pixels, and the pixels LRH filled (ignore -> class), flipped (class ->
class) and dropped (class -> ignore), with their accuracy.

    python -m regda_tpu_torch.tools.lrh_mechanism \\
        --ckpt-model <stage1>/Vaihingen_best.pth \\
        --ckpt-proto <stage1>/prototypes_best.npy [--device cpu]

The forward is the train-mode dual-head pass of the stage-2 step with the
same dropout seed for every batch, as the JAX tool's fixed key; on the card
`homogenize` runs the segment-histogram kernel. `python -m
regda_tpu_torch.tools.run_parity --mechanism` drives it and writes the
table.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from regda_tpu_torch.datasets import get_meta, make_loader
from regda_tpu_torch.entry import _device
from regda_tpu_torch.ops.lrh import homogenize
from regda_tpu_torch.ops.pseudo import pseudo_selection
from regda_tpu_torch.ops.refine import label_refine
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners
from regda_tpu_torch.tools.train_src import build_model
from regda_tpu_torch.utils.checkpoint import load_prototypes
from regda_tpu_torch.utils.tools import disable_tf32, import_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='LRH mechanism measurement.')
    parser.add_argument('--config-path', type=str, default='st.regda.parity_smoke')
    parser.add_argument('--ckpt-model', type=str, required=True)
    parser.add_argument('--ckpt-proto', type=str, required=True)
    parser.add_argument('--refine-label', type=int, default=1)
    parser.add_argument('--refine-temp', type=float, default=2.0)
    parser.add_argument('--percent', type=float, default=0.5)
    parser.add_argument('--json-out', type=str, default='')
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def _stats(label, gt, ignore):
    lab = label != ignore
    acc = float((label == gt)[lab].mean()) if lab.any() else 0.0
    return dict(coverage=float(lab.mean()), acc_labeled=acc,
                labeled=int(lab.sum()), total=int(gt.size))


def _acc(hit, where):
    return float(hit[where].mean()) if where.any() else 0.0


def main(argv=None) -> dict:
    """Returns the scores (also printed, and written to `--json-out`)."""
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    disable_tf32()
    cfg = import_config(args.config_path, create=False, copy=False)
    meta = get_meta(cfg.DATASETS)
    nc, ig = meta.num_classes, meta.ignore_label
    model = build_model(cfg, nc, device, args.ckpt_model).train()
    protos = torch.from_numpy(load_prototypes(args.ckpt_proto)).to(device)

    # the target train tiles under eval transforms with their ground truth
    # and region maps (PSEUDO_DATA_CONFIG pairs them with no random geometry)
    tcfg = dict(cfg.PSEUDO_DATA_CONFIG)
    tcfg['read_sup'] = True
    loader = make_loader(tcfg, cfg.DATASETS)

    before, after, gts = [], [], []
    with torch.no_grad():
        for batch in loader:
            imgs = torch.from_numpy(batch['image']).to(device)
            regs = torch.from_numpy(batch['sup'].astype(np.int32)).to(device)
            p1, p2, feat = model(imgs, torch.Generator(device=device).manual_seed(0))
            hw = tuple(imgs.shape[1:3])
            soft = (torch.softmax(resize_bilinear_align_corners(p1, hw), -1)
                    + torch.softmax(resize_bilinear_align_corners(p2, hw), -1)) * 0.5
            if args.refine_label:
                soft = label_refine(feat, [p1, p2], soft, protos, mode='all',
                                    temp=args.refine_temp)
            hard = pseudo_selection(soft, cfg.CUTOFF_TOP, cfg.CUTOFF_LOW, ig)
            refined = homogenize(hard, regs, args.percent, nc, ig)
            before.append(hard.cpu().numpy())
            after.append(refined.cpu().numpy())
            gts.append(np.asarray(batch['cls'], np.int32))
    b, a, gt = np.concatenate(before), np.concatenate(after), np.concatenate(gts)

    res = dict(before=_stats(b, gt, ig), after=_stats(a, gt, ig))
    filled = (b == ig) & (a != ig)
    flipped = (b != ig) & (a != ig) & (a != b)
    dropped = (b != ig) & (a == ig)
    res['transitions'] = dict(
        filled=dict(n=int(filled.sum()), acc=_acc(a == gt, filled)),
        flipped=dict(n=int(flipped.sum()), acc_before=_acc(b == gt, flipped),
                     acc_after=_acc(a == gt, flipped)),
        dropped=dict(n=int(dropped.sum()), acc_before=_acc(b == gt, dropped)))
    print(json.dumps(res, indent=2))
    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == '__main__':
    main()
