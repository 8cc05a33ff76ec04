"""Stage 1: source-supervised training (+ optional CORAL domain alignment).

The port's counterpart of tools/train_src.py (reference tools/train_src.py
:29-37), with the same flags and `--device`:

  python -m regda_tpu_torch.tools.train_src --config-path st.regda.2vaihingen \\
      --align-domain 1 [--device cuda]

Checkpoints go to the config's SNAPSHOT_DIR + '/src' as `.pth` files under
the reference's key names (train/loop.py). `--pretrained-ckpt` takes such a
`.pth`. The run is on the card unless `--device cpu` asks otherwise, and
float32 stays float32 there: TF32 is switched off for cuDNN's convolutions
and cuBLAS's matmuls, which would otherwise take it by default.

Under `torchrun --nproc_per_node N -m regda_tpu_torch.tools.train_src ...` the run is
data-parallel over N ranks, one a card: `--device cuda` means
`cuda:{LOCAL_RANK}`, the batch is split over the ranks (N must divide
it), and the first rank logs and writes every file (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from regda_tpu_torch.datasets import InfiniteIterator, get_meta, make_loader
from regda_tpu_torch.entry import _device
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.parallel import broadcast_module, data_group_from_env, is_primary, shutdown
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage1_step
from regda_tpu_torch.utils.checkpoint import load_checkpoint
from regda_tpu_torch.utils.tools import (count_model_parameters, default_seed,
                                         disable_tf32, get_rank_logger, import_config,
                                         logging_args, logging_cfg, seed_all, str2bool)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Train in src.')
    parser.add_argument('--config-path', type=str, default='st.regda.2vaihingen')
    parser.add_argument('--auto-resume', type=str2bool, default=0,
                        help='restore the full train state from SNAPSHOT_DIR'
                             ' and continue (elastic recovery)')
    parser.add_argument('--align-domain', type=str2bool, default=0)
    parser.add_argument('--ls', type=str, default='CrossEntropy',
                        choices=['CrossEntropy', 'OhemCrossEntropy'])
    parser.add_argument('--bcs', type=str2bool, default=0,
                        help='whether balance class for source')
    parser.add_argument('--class-temp', type=float, default=2.0)
    parser.add_argument('--pretrained-ckpt', type=str, default=None,
                        help='optional init: a .pth state_dict under the reference key names')
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def build_model(cfg, num_classes: int, device: torch.device, ckpt: str | None = None):
    """The config's DeepLabv2 with the seeded initialisation (or `ckpt`'s
    weights) on `device`, channels-last; with per-block gradient
    checkpointing where the config sets `REMAT = True`, as the JAX CLIs
    read it."""
    model = build_deeplabv2(cfg.MODEL, num_classes, remat=getattr(cfg, 'REMAT', False),
                            generator=torch.Generator().manual_seed(default_seed()))
    if ckpt:
        load_checkpoint(model, ckpt)
    return model.to(device, memory_format=torch.channels_last)


def main(argv=None) -> types.SimpleNamespace:
    """Run stage 1; returns the trainer and the two loaders."""
    args = build_parser().parse_args(argv)
    group = data_group_from_env(args.device)
    device = group.device if group is not None else _device(args.device)
    disable_tf32()
    seed_all()
    time_from = time.time()
    cfg = import_config(args.config_path, create=True, copy=is_primary(group),
                        postfix='/src')
    logger = get_rank_logger(args.config_path.split('.')[1], cfg.SNAPSHOT_DIR, group)
    logging_args(args, logger)
    logging_cfg(cfg, logger)

    meta = get_meta(cfg.DATASETS)
    stop_steps = cfg.STAGE1_STEPS
    model = build_model(cfg, meta.num_classes, device, args.pretrained_ckpt)
    broadcast_module(model, group)
    if args.pretrained_ckpt:
        logger.info(f'loaded init from {args.pretrained_ckpt}')
    optimizer = make_optimizer(model, cfg.LEARNING_RATE, stop_steps,
                               momentum=cfg.MOMENTUM, weight_decay=cfg.WEIGHT_DECAY,
                               power=cfg.POWER)
    state = create_train_state(model, optimizer,
                               torch.Generator(device=device).manual_seed(default_seed()))
    count_model_parameters(model.state_dict(), logger)

    step_fn = make_stage1_step(align_domain=bool(args.align_domain), ls=args.ls,
                               bcs=bool(args.bcs), class_temp=args.class_temp,
                               num_classes=meta.num_classes,
                               ignore_label=meta.ignore_label, group=group)
    trainer = Trainer(model, cfg, logger, state, step_fn, group)
    start_iter = trainer.try_resume() if args.auto_resume else 0

    sourceloader = make_loader(cfg.SOURCE_DATA_CONFIG, cfg.DATASETS, logger=logger)
    targetloader = make_loader(cfg.TARGET_DATA_CONFIG, cfg.DATASETS, logger=logger)
    source_iter = InfiniteIterator(sourceloader)
    target_iter = InfiniteIterator(targetloader)
    logger.info(f'batch num: source={len(sourceloader)}, '
                f'target={len(targetloader)}')
    logger.info('epochs ~= %.3f' % (stop_steps / len(sourceloader)))

    for i_iter in range(start_iter, stop_steps):
        bs = source_iter.next()
        bt = target_iter.next()
        metrics = trainer.run_step(
            i_iter=i_iter,
            images_s=bs['image'], label_s=bs['cls'].astype(np.int32),
            images_t=bt['image'])
        trainer.maybe_log(i_iter, metrics)
        trainer.maybe_eval(i_iter, stop_steps)

    trainer.join_saver()
    logger.info(f'>>>> Using {(time.time() - time_from) / 3600:.3f} hours.')
    return types.SimpleNamespace(trainer=trainer, source=sourceloader, target=targetloader)


if __name__ == '__main__':
    main()
    shutdown()
