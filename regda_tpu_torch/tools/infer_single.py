"""Single-image inference: the predicted class ids and a palette PNG.

The port's counterpart of tools/infer_single.py (reference
tools/infer_single.py:14-70), with the same arguments and `--device`:

  python -m regda_tpu_torch.tools.infer_single st.regda.2vaihingen <ckpt.pth> <image> \\
      [--save-dir ./demo] [--ins-norm 1] [--slide 1] [--tta 0] [--gt 0] [--device cuda]

It writes `prediction.png` (class ids), `prediction_color.png` (the
dataset's palette) and, with `--gt 1`, `gt.png` from the image's `ann_dir`
twin. The config is one of the port's (`regda_tpu_torch/configs/`). The
checkpoint is a `.pth` state_dict under the reference's key names, the file
that the reference, the port and the JAX package's `load_pytree` all read;
every parameter must be in it under its name, or the load raises KeyError.
The run is on the card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from regda_tpu_torch.datasets import get_meta
from regda_tpu_torch.entry import _device
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.utils.checkpoint import load_checkpoint
from regda_tpu_torch.utils.tools import import_config, str2bool
from regda_tpu_torch.utils.viz import VisualizeSegmm


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Run predict methods.')
    parser.add_argument('config_path', type=str)
    parser.add_argument('ckpt_path', type=str)
    parser.add_argument('image_path', type=str)
    parser.add_argument('--save-dir', type=str, default='./demo')
    parser.add_argument('--ins-norm', type=str2bool, default=True)
    parser.add_argument('--slide', type=str2bool, default=True)
    parser.add_argument('--tta', type=str2bool, default=False)
    parser.add_argument('--gt', type=str2bool, default=False)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None) -> None:
    from PIL import Image
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = import_config(args.config_path, copy=False, create=False)
    meta = get_meta(cfg.DATASETS)

    model = build_deeplabv2(cfg.MODEL, meta.num_classes, is_ins_norm=args.ins_norm)
    load_checkpoint(model, args.ckpt_path)
    model = model.to(device, memory_format=torch.channels_last).eval()
    viz_op = VisualizeSegmm(args.save_dir, meta.palette)

    trans = cfg.TEST_DATA_CONFIG['transforms']
    img = np.asarray(Image.open(args.image_path)).astype(np.float32)
    sample = trans({'image': img}, np.random.default_rng(0))
    batch = sample['image'][None]  # (1, H, W, 3)

    inferencer = SegInferencer(model, meta.num_classes)
    cls = inferencer.predict_labels(batch, slide=args.slide, tta=args.tta)[0].astype(np.uint8)

    Image.fromarray(cls).save(os.path.join(args.save_dir, 'prediction.png'))
    viz_op(cls, 'prediction_color.png')
    if args.gt:
        gt_path = str(args.image_path).replace('img_dir', 'ann_dir')
        if os.path.exists(gt_path):
            print(gt_path)
            viz_op(np.asarray(Image.open(gt_path)), 'gt.png')


if __name__ == '__main__':
    main()
