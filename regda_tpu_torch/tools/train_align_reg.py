"""Stage 2: prototype-contrastive alignment + online pseudo-labels + LRH.

The port's counterpart of tools/train_align_reg.py (reference
tools/train_align_reg.py:35-61), with the same flags and `--device`:

  python -m regda_tpu_torch.tools.train_align_reg --config-path st.regda.2vaihingen \\
      --ckpt-model log/regda/2vaihingen/src/Vaihingen_best.pth \\
      --ckpt-proto log/regda/2vaihingen/src/prototypes_best.npy \\
      --align-domain 1 --refine-label 1 --sam-refine --percent 0.5

`--ckpt-model` is a `.pth` state_dict under the reference key names,
`--ckpt-proto` the `.npy` (or bare-tensor `.pth`) of init_prototypes. The
region maps come from the target tree's `reg_dir`. Checkpoints go to the
config's SNAPSHOT_DIR + '/align', and the final prototypes to
`prototypes_best.npy` there. The run is on the card unless `--device cpu`
asks otherwise, and float32 stays float32 there: TF32 is switched off for
cuDNN's convolutions and cuBLAS's matmuls, which would otherwise take it by
default.

Under `torchrun --nproc_per_node N -m regda_tpu_torch.tools.train_align_reg ...` the run is
data-parallel over N ranks, one a card: `--device cuda` means
`cuda:{LOCAL_RANK}`, the batch is split over the ranks (N must divide
it), and the first rank logs and writes every file (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import os
import time
import types

import numpy as np
import torch

from regda_tpu_torch.datasets import InfiniteIterator, get_meta, make_loader
from regda_tpu_torch.datasets.device_data import astype
from regda_tpu_torch.entry import _device
from regda_tpu_torch.parallel import (barrier, broadcast_module, data_group_from_env,
                                      is_primary, shutdown)
from regda_tpu_torch.tools.train_src import build_model
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage2_step
from regda_tpu_torch.utils.checkpoint import load_prototypes, save_prototypes
from regda_tpu_torch.utils.tools import (default_seed, disable_tf32, get_rank_logger,
                                         import_config, logging_args, logging_cfg,
                                         seed_all, str2bool)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Train align by pcl with uem.')
    parser.add_argument('--config-path', type=str, default='st.regda.2vaihingen')
    parser.add_argument('--auto-resume', type=str2bool, default=0,
                        help='restore the full train state from SNAPSHOT_DIR'
                             ' and continue (elastic recovery)')
    parser.add_argument('--ckpt-model', type=str, required=True)
    parser.add_argument('--ckpt-proto', type=str, required=True)
    parser.add_argument('--gen', type=str2bool, default=1)
    parser.add_argument('--align-domain', type=str2bool, default=0)
    parser.add_argument('--refine-label', type=str2bool, default=1)
    parser.add_argument('--refine-mode', type=str, default='all', choices=['all'])
    parser.add_argument('--refine-temp', type=float, default=2.0)
    parser.add_argument('--sam-refine', action='store_true', help='whether lrh')
    parser.add_argument('--percent', type=float, default=0.5)
    parser.add_argument('--ls', type=str, default='CrossEntropy',
                        choices=['CrossEntropy', 'OhemCrossEntropy'])
    parser.add_argument('--bcs', type=str2bool, default=0)
    parser.add_argument('--class-temp', type=float, default=2.0)
    parser.add_argument('--pcl-temp', type=float, default=8.0)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None) -> types.SimpleNamespace:
    """Run stage 2; returns the trainer and the two loaders."""
    args = build_parser().parse_args(argv)
    group = data_group_from_env(args.device)
    device = group.device if group is not None else _device(args.device)
    disable_tf32()
    seed_all()
    time_from = time.time()
    cfg = import_config(args.config_path, create=True, copy=is_primary(group),
                        postfix='/align')
    logger = get_rank_logger(args.config_path.split('.')[1], cfg.SNAPSHOT_DIR, group)
    logging_args(args, logger)
    logging_cfg(cfg, logger)

    meta = get_meta(cfg.DATASETS)
    stop_steps = cfg.STAGE2_STEPS
    model = build_model(cfg, meta.num_classes, device, args.ckpt_model)
    broadcast_module(model, group)
    optimizer = make_optimizer(model, cfg.LEARNING_RATE, stop_steps,
                               momentum=cfg.MOMENTUM, weight_decay=cfg.WEIGHT_DECAY,
                               power=cfg.POWER)
    protos = torch.from_numpy(load_prototypes(args.ckpt_proto))
    state = create_train_state(model, optimizer,
                               torch.Generator(device=device).manual_seed(default_seed()),
                               protos)
    logger.info(f'prototypes({tuple(protos.shape)}) loaded from {args.ckpt_proto}')

    step_fn = make_stage2_step(
        align_domain=bool(args.align_domain), refine_label=bool(args.refine_label),
        refine_mode=args.refine_mode, refine_temp=args.refine_temp,
        sam_refine=bool(args.sam_refine), percent=args.percent, ls=args.ls,
        bcs=bool(args.bcs), class_temp=args.class_temp, pcl_temp=args.pcl_temp,
        num_classes=meta.num_classes, ignore_label=meta.ignore_label,
        cutoff_top=cfg.CUTOFF_TOP, cutoff_low=cfg.CUTOFF_LOW, group=group)
    trainer = Trainer(model, cfg, logger, state, step_fn, group)
    start_iter = trainer.try_resume() if args.auto_resume else 0

    sourceloader = make_loader(cfg.SOURCE_DATA_CONFIG, cfg.DATASETS, logger=logger,
                               device=device)
    # stage 2 target loader: same id-label target dirs as stage 1 but with
    # SAM region maps (sup) attached (train_align_reg.py:161-163)
    target_config = dict(cfg.TARGET_DATA_CONFIG)
    target_config['label_type'] = 'id'
    target_config['mask_dir'] = None
    target_config['read_sup'] = True
    targetloader = make_loader(target_config, cfg.DATASETS, logger=logger, device=device)
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
            images_s=bs['image'], label_s=astype(bs['cls'], np.int32),
            images_t=bt['image'], regs_t=astype(bt['sup'], np.int32))
        trainer.maybe_log(i_iter, metrics)
        trainer.maybe_eval(i_iter, stop_steps, eval_at_zero=True)

    trainer.join_saver()
    # final prototypes for stage 3
    if is_primary(group):
        save_prototypes(os.path.join(cfg.SNAPSHOT_DIR, 'prototypes_best'),
                        trainer.state.prototypes)
    barrier(group)
    logger.info(f'>>>> Using {(time.time() - time_from) / 3600:.3f} hours.')
    return types.SimpleNamespace(trainer=trainer, source=sourceloader, target=targetloader)


if __name__ == '__main__':
    main()
    shutdown()
