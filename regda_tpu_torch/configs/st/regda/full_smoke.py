"""Full-shape stage smoke: the reference recipe's EXACT schedule/shapes on
synthetic data.

No real ISPRS data exists on this box, so loop-level validation at
reference scale (batch 8 x 512^2 crops, ResNet-101, 4000-step stage 1,
eval/checkpoint every 500 — configs/st/regda/2vaihingen.py:14-25 and
tools/train_src.py:106-166 in the reference) runs on a synthetic
learnable dataset of 512^2 tiles. Used by the round-2 full-length
stage-1 drive (kill + --auto-resume included); see FULLRUN.md.

    REGDA_FULL_STEPS=4000 python tools/train_src.py \
        --config-path st.regda.full_smoke --auto-resume 1
"""

import os

import numpy as np

from regda_tpu_torch.configs._base import data_configs, prob_target_transforms

_ROOT = os.environ.get('REGDA_FULL_ROOT', '/tmp/regda_full_smoke')
_HW = 512
_C = 6
_CELL = _HW // 8


def _materialize():
    from PIL import Image
    marker = os.path.join(_ROOT, '.v1_full')
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(3)
    palette = rng.integers(40, 215, (_C, 3)).astype(np.float32)
    palette_t = (0.55 * palette + 0.45 * np.roll(palette, 1, axis=-1)
                 + 28.0)
    domains = {'Potsdam': palette, 'Vaihingen': palette_t}
    for domain, pal in domains.items():
        for split, n in (('train', 32), ('val', 8), ('test', 8)):
            img_dir = os.path.join(_ROOT, domain, 'img_dir', split)
            ann_dir = os.path.join(_ROOT, domain, 'ann_dir', split)
            reg_dir = os.path.join(_ROOT, domain, 'reg_dir', split)
            for d in (img_dir, ann_dir, reg_dir):
                os.makedirs(d, exist_ok=True)
            for i in range(n):
                block = rng.integers(0, _C, (8, 8)).astype(np.uint8)
                lbl = np.kron(block, np.ones((_CELL, _CELL), np.uint8))
                img = pal[lbl] + rng.normal(0, 14, (_HW, _HW, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                cell_ids = np.arange(1, 65, dtype=np.int32).reshape(8, 8)
                reg = np.kron(cell_ids, np.ones((_CELL, _CELL), np.int32))
                Image.fromarray(img).save(os.path.join(img_dir, f't{i}.png'))
                Image.fromarray(lbl).save(os.path.join(ann_dir, f't{i}.png'))
                Image.fromarray(reg, mode='I').save(
                    os.path.join(reg_dir, f't{i}.tif'))
    open(marker, 'w').write('v1')


_materialize()

DATASETS = 'IsprsDA'
TARGET_SET = 'Vaihingen'

_stats = ((127.0, 127.0, 127.0), (50.0, 50.0, 50.0))
source_dir = dict(image_dir=[f'{_ROOT}/Potsdam/img_dir/train'],
                  mask_dir=[f'{_ROOT}/Potsdam/ann_dir/train'])
target_dir = dict(image_dir=[f'{_ROOT}/Vaihingen/img_dir/train'],
                  mask_dir=[f'{_ROOT}/Vaihingen/ann_dir/train'])
val_dir = dict(image_dir=[f'{_ROOT}/Vaihingen/img_dir/val'],
               mask_dir=[f'{_ROOT}/Vaihingen/ann_dir/val'])
test_dir = dict(image_dir=[f'{_ROOT}/Vaihingen/img_dir/test'],
                mask_dir=[f'{_ROOT}/Vaihingen/ann_dir/test'])

(SOURCE_DATA_CONFIG, _TARGET_ID_CONFIG, PSEUDO_DATA_CONFIG,
 EVAL_DATA_CONFIG, TEST_DATA_CONFIG) = data_configs(
    source_dir, target_dir, val_dir, test_dir, _stats, _stats,
    crop=_HW, batch_size=8, num_workers=2)

MODEL = 'ResNet101'
IGNORE_LABEL = -1
MOMENTUM = 0.9
SNAPSHOT_DIR = os.path.join(_ROOT, 'log')
WEIGHT_DECAY = 0.0005
LEARNING_RATE = 1e-2
STAGE1_STEPS = int(os.environ.get('REGDA_FULL_STEPS', 4000))
STAGE2_STEPS = int(os.environ.get('REGDA_FULL_STEPS2', 6000))
STAGE3_STEPS = int(os.environ.get('REGDA_FULL_STEPS3', 6000))
NUM_STEPS = None
PREHEAT_STEPS = None
POWER = 0.9
EVAL_EVERY = 500
GENE_EVERY = 1000
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
    batch_size=8,
    num_workers=2,
    label_type='prob',
    read_sup=True,
)

# pseudo-label maps must match the synthetic tile size (the reference
# default, the dataset meta SIZE, only equals the tile size on real data)
PSEUDO_SIZE = (_HW, _HW)
