"""LoveDA-flavored smoke config: synthetic Urban/Rural-style trees with the
LoveDA label convention (png ids 0..7, offset -1, 7 classes), so the LoveDA
meta path of every stage CLI can be driven end-to-end without real data.

  python tools/train_src.py --config-path st.regda.tiny_smoke_loveda
"""

import os

import numpy as np

from regda_tpu_torch.configs._base import data_configs, prob_target_transforms

_ROOT = os.environ.get('REGDA_SMOKE_ROOT_LOVEDA', '/tmp/regda_tiny_loveda')
_HW = 64
_C = 7


def _materialize():
    from PIL import Image
    rng = np.random.default_rng(1)
    for domain in ('Urban', 'Rural'):
        for split, n in (('train', 4), ('val', 2), ('test', 2)):
            img_dir = os.path.join(_ROOT, domain, 'img_dir', split)
            ann_dir = os.path.join(_ROOT, domain, 'ann_dir', split)
            reg_dir = os.path.join(_ROOT, domain, 'reg_dir', split)
            if os.path.isdir(img_dir) and os.listdir(img_dir):
                continue
            for d in (img_dir, ann_dir, reg_dir):
                os.makedirs(d, exist_ok=True)
            for i in range(n):
                img = rng.integers(0, 255, (_HW, _HW, 3)).astype(np.uint8)
                # LoveDA png convention: 0 = ignore, 1..7 = classes
                block = rng.integers(0, _C + 1, (2, 2)).astype(np.uint8)
                lbl = np.kron(block, np.ones((_HW // 2, _HW // 2), np.uint8))
                reg = np.kron(rng.integers(0, 5, (4, 4)),
                              np.ones((_HW // 4, _HW // 4))).astype(np.int32)
                Image.fromarray(img).save(os.path.join(img_dir, f't{i}.png'))
                Image.fromarray(lbl).save(os.path.join(ann_dir, f't{i}.png'))
                Image.fromarray(reg, mode='I').save(
                    os.path.join(reg_dir, f't{i}.tif'))


_materialize()

DATASETS = 'LoveDA'
TARGET_SET = 'Urban'

_stats = ((73.5, 80.0, 74.6), (41.5, 35.7, 33.8))
source_dir = dict(image_dir=[f'{_ROOT}/Rural/img_dir/train'],
                  mask_dir=[f'{_ROOT}/Rural/ann_dir/train'])
target_dir = dict(image_dir=[f'{_ROOT}/Urban/img_dir/train'],
                  mask_dir=[f'{_ROOT}/Urban/ann_dir/train'])
val_dir = dict(image_dir=[f'{_ROOT}/Urban/img_dir/val'],
               mask_dir=[f'{_ROOT}/Urban/ann_dir/val'])
test_dir = dict(image_dir=[f'{_ROOT}/Urban/img_dir/test'],
                mask_dir=[f'{_ROOT}/Urban/ann_dir/test'])

(SOURCE_DATA_CONFIG, _TARGET_ID_CONFIG, PSEUDO_DATA_CONFIG,
 EVAL_DATA_CONFIG, TEST_DATA_CONFIG) = data_configs(
    source_dir, target_dir, val_dir, test_dir, _stats, _stats,
    crop=_HW, batch_size=2, num_workers=0)

MODEL = 'resnet18'
IGNORE_LABEL = -1
MOMENTUM = 0.9
SNAPSHOT_DIR = os.path.join(_ROOT, 'log')
WEIGHT_DECAY = 0.0005
LEARNING_RATE = 1e-2
STAGE1_STEPS = 6
STAGE2_STEPS = 6
STAGE3_STEPS = 6
NUM_STEPS = None
PREHEAT_STEPS = None
POWER = 0.9
EVAL_EVERY = 6
GENE_EVERY = 6
CUTOFF_TOP = 0.8
CUTOFF_LOW = 0.6
PSEUDO_SELECT = True
CROP_SIZE = _HW

TARGET_DATA_CONFIG = dict(
    image_dir=target_dir['image_dir'],
    mask_dir=[None],
    transforms=prob_target_transforms(*_stats, crop=_HW),
    CV=dict(k=10, i=-1),
    training=True,
    batch_size=2,
    num_workers=0,
    label_type='prob',
    read_sup=True,
)

# pseudo-label maps must match the synthetic tile size (the reference
# default, the dataset meta SIZE, only equals the tile size on real data)
PSEUDO_SIZE = (_HW, _HW)
