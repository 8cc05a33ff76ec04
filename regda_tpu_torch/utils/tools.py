"""CLI, config and logging plumbing (counterpart of regda_tpu/utils/tools.py).

Parity targets: regda/utils/tools.py:24-30 (str2bool), :173-181
(import_config: dotted-path module import + SNAPSHOT_DIR postfix + config
provenance copy), :221-237 (console+file logger), :401-407 (parameter count);
`logging_args` / `logging_cfg` as regda_tpu/utils/tools.py:60-73.
Configs resolve under the port's own `regda_tpu_torch.configs` package.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import shutil
import sys
import time
from typing import Mapping

import numpy as np
import torch


def str2bool(v: str) -> bool:
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError('Unsupported value encountered.')


def import_config(config_name: str, prefix: str = 'regda_tpu_torch.configs',
                  copy: bool = True, create: bool = True, postfix: str = ''):
    """Import `<prefix>.<config_name>` (e.g. 'st.regda.2vaihingen'); append
    `postfix` to its SNAPSHOT_DIR, create that directory and copy the config
    file into it as config.py, as asked.

    Each call executes the config module afresh, and the config modules it
    imports (an overlay such as `tiny_smoke_remat` star-imports its base), so
    a second call in one process (another stage, another postfix, another
    overlay) starts from the config's own SNAPSHOT_DIR, not from the one an
    earlier call extended."""
    name = f'{prefix}.{config_name}'
    for key in [k for k, m in sys.modules.items()
                if k.startswith(prefix + '.') and not hasattr(m, '__path__')]:
        sys.modules.pop(key)
    m = importlib.import_module(name)
    m.SNAPSHOT_DIR += postfix
    if create:
        os.makedirs(m.SNAPSHOT_DIR, exist_ok=True)
    if copy:
        shutil.copy(m.__file__, os.path.join(m.SNAPSHOT_DIR, 'config.py'))
    return m


def get_console_file_logger(name: str, level=logging.INFO,
                            logdir: str = './baseline') -> logging.Logger:
    logger = logging.Logger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s, %(levelname)s:%(name)s:%(message)s",
                            '%Y-%m-%d %H:%M:%S')
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    ch.setLevel(level)
    logger.addHandler(ch)
    os.makedirs(logdir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(logdir, str(time.time()) + '.log'))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def get_rank_logger(name: str, logdir: str, group=None) -> logging.Logger:
    """The stage CLIs' logger: console and file on the first rank of a
    data-parallel run (a parallel.DataGroup) or on its own; on the other
    ranks warnings only, to the console."""
    if group is None or group.rank == 0:
        return get_console_file_logger(name, logdir=logdir)
    logger = logging.getLogger(f'{name}.rank{group.rank}')
    logger.setLevel(logging.WARNING)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    return logger


def logging_args(args, logger):
    logger.info('>>>>>>>>>>>>>>>>>>>>> arguments logging begin:')
    for k, v in vars(args).items():
        logger.info(f'{k}={v}')
    logger.info('<<<<<<<<<<<<<<<<<<<<< arguments logging end!')


def logging_cfg(cfg, logger):
    logger.info('>>>>>>>>>>>>>>>>>>>>> config logging begin:')
    logger.info(cfg.__name__)
    for k, v in vars(cfg).items():
        if not str(k).startswith('__'):
            logger.info(f'{k}={v}')
    logger.info('<<<<<<<<<<<<<<<<<<<<< config logging end!')


def default_seed() -> int:
    """2333 (the reference's seed_torch(2333), tools/train_src.py:169-172)
    unless REGDA_SEED overrides it."""
    return int(os.environ.get('REGDA_SEED', '2333'))


def seed_all(seed: int = None):
    """Seed Python's, numpy's and torch's global generators (the port's own
    random draws take explicit `torch.Generator`s)."""
    import random
    seed = default_seed() if seed is None else seed
    random.seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def disable_tf32() -> None:
    """Hold float32 as float32 on the card: cuDNN's convolutions and cuBLAS's
    matmuls would otherwise take TF32's 10-bit mantissa by default."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


_STAT_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')


def count_model_parameters(state_dict: Mapping[str, torch.Tensor], logger=None) -> int:
    """Number of parameter values in a state_dict. BatchNorm running
    statistics are buffers, not parameters, and are left out, as the
    reference counts `model.parameters()`."""
    cnt = sum(int(v.numel()) for k, v in state_dict.items()
              if not k.endswith(_STAT_SUFFIXES))
    if logger is not None:
        logger.info('#params: {}, {} M'.format(cnt, round(cnt / 1e6, 3)))
    return cnt
