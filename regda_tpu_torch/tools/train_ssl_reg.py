"""Stage 3: offline pseudo-label generation + self-training with UVEM/LRH.

The port's counterpart of tools/train_ssl_reg.py (reference
tools/train_ssl_reg.py:34-65), with the same flags and `--device`:

  python -m regda_tpu_torch.tools.train_ssl_reg --config-path st.regda.2vaihingen \\
      --ckpt-model log/regda/2vaihingen/align/Vaihingen_best.pth \\
      --ckpt-proto log/regda/2vaihingen/align/prototypes_best.npy \\
      --gen 1 --refine-label 1 --sam-refine --percent 0.5 --lt uvem

The stage-2 model first writes one probability map per target tile
(`pseudo.py:gener_target_pseudo`, slide + TTA) under SNAPSHOT_DIR/
pseudo_label; the target loader then reads them as 'prob' labels beside the
region maps, and the directory is removed at the end. Checkpoints go to the
config's SNAPSHOT_DIR + '/ssl'. The run is on the card unless `--device cpu`
asks otherwise, and float32 stays float32 there: TF32 is switched off for
cuDNN's convolutions and cuBLAS's matmuls, which would otherwise take it by
default.

Under `torchrun --nproc_per_node N -m regda_tpu_torch.tools.train_ssl_reg ...` the run is
data-parallel over N ranks, one a card: `--device cuda` means
`cuda:{LOCAL_RANK}`, the batch is split over the ranks (N must divide
it), and the first rank logs and writes every file (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
import types

import numpy as np
import torch

from regda_tpu_torch.datasets import (InfiniteIterator, device_data_enabled, eval_loader,
                                      get_meta, make_loader)
from regda_tpu_torch.datasets.device_data import astype
from regda_tpu_torch.entry import _device
from regda_tpu_torch.parallel import (barrier, broadcast_module, data_group_from_env,
                                      is_primary, shutdown)
from regda_tpu_torch.pseudo import gener_target_pseudo
from regda_tpu_torch.tools.train_src import build_model
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage3_step
from regda_tpu_torch.utils.checkpoint import load_prototypes
from regda_tpu_torch.utils.tools import (default_seed, disable_tf32, get_rank_logger,
                                         import_config, logging_args, logging_cfg,
                                         seed_all, str2bool)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Run regda methods. ssl')
    parser.add_argument('--config-path', type=str, default='st.regda.2vaihingen')
    parser.add_argument('--auto-resume', type=str2bool, default=0,
                        help='restore the full train state from SNAPSHOT_DIR'
                             ' and continue (elastic recovery)')
    parser.add_argument('--ckpt-model', type=str, required=True)
    parser.add_argument('--ckpt-proto', type=str, required=True)
    parser.add_argument('--gen', type=str2bool, default=1)
    parser.add_argument('--refine-label', type=str2bool, default=1)
    parser.add_argument('--refine-mode', type=str, default='all', choices=['all'])
    parser.add_argument('--refine-temp', type=float, default=2.0)
    parser.add_argument('--sam-refine', action='store_true', help='whether LRH')
    parser.add_argument('--percent', type=float, default=0.5)
    parser.add_argument('--ls', type=str, default='CrossEntropy',
                        choices=['CrossEntropy', 'OhemCrossEntropy'])
    parser.add_argument('--bcs', type=str2bool, default=0)
    parser.add_argument('--lt', type=str, default='none',
                        choices=['ours', 'uvem', 'ohem', 'focal', 'ghm', 'ups', 'none'])
    parser.add_argument('--bct', type=str2bool, default=0)
    parser.add_argument('--class-temp', type=float, default=2.0)
    parser.add_argument('--uvem-m', type=float, default=0.2)
    parser.add_argument('--uvem-t', type=float, default=0.7)
    parser.add_argument('--uvem-g', type=float, default=4)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None) -> types.SimpleNamespace:
    """Run stage 3; returns the trainer, the two training loaders and the
    pseudo-label directory (removed by the time this returns)."""
    args = build_parser().parse_args(argv)
    group = data_group_from_env(args.device)
    device = group.device if group is not None else _device(args.device)
    disable_tf32()
    seed_all()
    time_from = time.time()
    cfg = import_config(args.config_path, create=True, copy=is_primary(group),
                        postfix='/ssl')
    save_pseudo_label_path = os.path.join(cfg.SNAPSHOT_DIR, 'pseudo_label')
    os.makedirs(save_pseudo_label_path, exist_ok=True)
    logger = get_rank_logger(args.config_path.split('.')[1], cfg.SNAPSHOT_DIR, group)
    logging_args(args, logger)
    logging_cfg(cfg, logger)

    meta = get_meta(cfg.DATASETS)
    stop_steps = cfg.STAGE3_STEPS
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

    step_fn = make_stage3_step(
        refine_label=bool(args.refine_label), refine_mode=args.refine_mode,
        refine_temp=args.refine_temp, sam_refine=bool(args.sam_refine),
        percent=args.percent, ls=args.ls, lt=args.lt, bcs=bool(args.bcs),
        bct=bool(args.bct), class_temp=args.class_temp, uvem_m=args.uvem_m,
        uvem_t=args.uvem_t, uvem_g=args.uvem_g, num_classes=meta.num_classes,
        ignore_label=meta.ignore_label, cutoff_top=cfg.CUTOFF_TOP,
        cutoff_low=cfg.CUTOFF_LOW, group=group)
    trainer = Trainer(model, cfg, logger, state, step_fn, group)
    start_iter = trainer.try_resume() if args.auto_resume else 0

    # offline pseudo-labels from the stage-2 weights: the trainer's
    # inferencer was built from them before any resume and is refreshed
    # only at its first eval, so it serves them here (the JAX CLI builds a
    # second inferencer over the loaded variables)
    if args.gen:
        logger.info('###### Start generate pseudo dataset! ######')
        pseudo_cfg = cfg.PSEUDO_DATA_CONFIG
        if device_data_enabled(pseudo_cfg):
            # images and names only: no label is read. The JAX CLI lets
            # DeviceCacheTooLarge escape here; this one falls back to the
            # host loader with a warning, as the eval does
            pseudo_cfg = dict(pseudo_cfg, mask_dir=None)
        pseudo_loader = eval_loader(pseudo_cfg, cfg.DATASETS, device, logger, 'pseudo-label')
        gener_target_pseudo(cfg, trainer.inferencer, pseudo_loader,
                            save_pseudo_label_path, save_prob=True, slide=True,
                            ignore_label=meta.ignore_label,
                            size=getattr(cfg, 'PSEUDO_SIZE', None), logger=logger)
    target_config = dict(cfg.TARGET_DATA_CONFIG)
    target_config['mask_dir'] = [save_pseudo_label_path]
    logger.info(str(target_config))
    targetloader = make_loader(target_config, cfg.DATASETS, logger=logger, device=device)
    logger.info('###### Start model retraining! ######')

    sourceloader = make_loader(cfg.SOURCE_DATA_CONFIG, cfg.DATASETS, logger=logger,
                               device=device)
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
            images_t=bt['image'], label_t_prob=astype(bt['cls'], np.float32),
            regs_t=astype(bt['sup'], np.int32))
        trainer.maybe_log(i_iter, metrics)
        trainer.maybe_eval(i_iter, stop_steps, eval_at_zero=True)

    trainer.join_saver()
    logger.info(f'>>>> Using {(time.time() - time_from) / 3600:.3f} hours.')
    barrier(group)             # every rank has read its last pseudo-labels
    if is_primary(group):
        shutil.rmtree(save_pseudo_label_path, ignore_errors=True)
    logger.info('removing pseudo labels')
    return types.SimpleNamespace(trainer=trainer, source=sourceloader, target=targetloader,
                                 pseudo_label=save_pseudo_label_path)


if __name__ == '__main__':
    main()
    shutdown()
