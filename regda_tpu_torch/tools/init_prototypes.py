"""Average per-class feature prototypes over the source set.

The port's counterpart of tools/init_prototypes.py (reference
tools/init_prototypes.py:33-44), with the same flags and `--device`:

  python -m regda_tpu_torch.tools.init_prototypes --config-path st.regda.2vaihingen \\
      --ckpt-model log/regda/2vaihingen/src/Vaihingen_best.pth \\
      --ckpt-proto log/regda/2vaihingen/src/prototypes_best

`--ckpt-model` is a `.pth` state_dict under the reference key names; the
prototypes go to `<ckpt-proto>.npy`. The run is on the card unless `--device
cpu` asks otherwise, and float32 stays float32 there (TF32 off for cuDNN and
cuBLAS, which would otherwise take it by default).

Under `torchrun --nproc_per_node N -m regda_tpu_torch.tools.init_prototypes
...` each of N ranks (one a card, `cuda:{LOCAL_RANK}`) runs its rows of
every batch, the per-class sums are summed over the ranks, and the first
rank writes the prototypes.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from regda_tpu_torch.datasets import get_meta, make_loader
from regda_tpu_torch.datasets.device_data import astype, batch_tensor
from regda_tpu_torch.entry import _device
from regda_tpu_torch.ops.prototypes import prototype_finalize
from regda_tpu_torch.parallel import (barrier, broadcast_module, data_group_from_env,
                                      is_primary, shard_batch, shutdown)
from regda_tpu_torch.tools.train_src import build_model
from regda_tpu_torch.train.steps import proto_accum_step
from regda_tpu_torch.utils.checkpoint import save_prototypes
from regda_tpu_torch.utils.tools import (disable_tf32, get_rank_logger, import_config,
                                         logging_args, logging_cfg, seed_all)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='init proto')
    parser.add_argument('--config-path', type=str, default='st.regda.2vaihingen')
    parser.add_argument('--ckpt-model', type=str, required=True)
    parser.add_argument('--ckpt-proto', type=str, required=True)
    parser.add_argument('--stage', type=int, default=1)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None) -> tuple[np.ndarray, np.ndarray]:
    """Returns the (C, K) prototypes and the (C, 1) pixel counts behind them."""
    args = build_parser().parse_args(argv)
    group = data_group_from_env(args.device)
    device = group.device if group is not None else _device(args.device)
    disable_tf32()
    seed_all()
    time_from = time.time()
    cfg = import_config(args.config_path, create=True, copy=False,
                        postfix='/src' if args.stage == 1 else '/align')
    logger = get_rank_logger(args.config_path.split('.')[1], cfg.SNAPSHOT_DIR, group)
    logging_args(args, logger)
    logging_cfg(cfg, logger)

    meta = get_meta(cfg.DATASETS)
    model = build_model(cfg, meta.num_classes, device, args.ckpt_model)
    broadcast_module(model, group)
    feat_dim = model.encoder.resnet.out_channels   # 512 for resnet18/34, else 2048
    data_sum = torch.zeros(meta.num_classes, feat_dim, device=device)
    data_cnt = torch.zeros(meta.num_classes, 1, device=device)

    sourceloader = make_loader(cfg.SOURCE_DATA_CONFIG, cfg.DATASETS, logger=logger,
                               device=device)
    for batch in sourceloader:
        images, labels = shard_batch(group, batch['image'], astype(batch['cls'], np.int32))
        data_sum, data_cnt = proto_accum_step(
            model, data_sum, data_cnt, batch_tensor(images, device),
            batch_tensor(labels, device), meta.num_classes, meta.ignore_label,
            group)

    prototypes = prototype_finalize(data_sum, data_cnt).cpu().numpy()
    counts = data_cnt.cpu().numpy()
    if is_primary(group):
        save_prototypes(args.ckpt_proto, prototypes)
    barrier(group)
    logger.info('finish init prototypes!')
    logger.info(f'examples cnt({counts.shape})={counts}')
    logger.info(f'prototypes({prototypes.shape}) saved to {args.ckpt_proto}')
    logger.info(f'>>>> Using {(time.time() - time_from) / 3600:.3f} hours.')
    return prototypes, counts


if __name__ == '__main__':
    main()
    shutdown()
