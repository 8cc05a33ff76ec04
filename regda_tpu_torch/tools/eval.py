"""Evaluate a checkpoint on the val/test split.

The port's counterpart of tools/eval.py (reference tools/eval.py:15-56),
with the same flags and `--device`:

  python -m regda_tpu_torch.tools.eval --config-path st.regda.2vaihingen \\
      --ckpt-path log/regda/2vaihingen/ssl/Vaihingen_best.pth --test 1 [--tta 1]

`--ckpt-path` is a `.pth` state_dict under the reference key names. The
metric table and the palette PNGs go beside the checkpoint. The run is on the
card unless `--device cpu` asks otherwise, and float32 stays float32 there
(TF32 off for cuDNN and cuBLAS, which would otherwise take it by default).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from regda_tpu_torch.datasets import get_meta
from regda_tpu_torch.entry import _device
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.utils.eval import evaluate
from regda_tpu_torch.utils.tools import (disable_tf32, get_console_file_logger,
                                         import_config, seed_all, str2bool)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Run predict methods.')
    parser.add_argument('--config-path', type=str, default='st.regda.2vaihingen')
    parser.add_argument('--ckpt-path', type=str, required=True)
    parser.add_argument('--multi-layer', type=str2bool, default=True)
    parser.add_argument('--ins-norm', type=str2bool, default=True)
    parser.add_argument('--test', type=str2bool, default=False,
                        help='evaluate the test set?')
    parser.add_argument('--tta', type=str2bool, default=False)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None):
    """Returns (metric table, mIoU)."""
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    disable_tf32()
    seed_all(2333)
    cfg = import_config(args.config_path, copy=False, create=False)
    cfg.SNAPSHOT_DIR = os.path.dirname(os.path.abspath(args.ckpt_path))
    logger = get_console_file_logger(name='Baseline', logdir=cfg.SNAPSHOT_DIR)

    meta = get_meta(cfg.DATASETS)
    model = build_deeplabv2(cfg.MODEL, meta.num_classes, multi_layer=args.multi_layer,
                            is_ins_norm=args.ins_norm)
    model = model.to(device, memory_format=torch.channels_last)
    return evaluate(model, None, cfg, is_training=False, ckpt_path=args.ckpt_path,
                    logger=logger, tta=args.tta, test=args.test)


if __name__ == '__main__':
    main()
