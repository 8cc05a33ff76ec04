"""Self-contained smoke config: fabricates a tiny synthetic ISPRS-style
dataset under /tmp/regda_tiny_smoke on import and trains a resnet18 for a
handful of steps. Exists so every stage CLI can be driven end-to-end on any
box (no real data, <1 min/stage on CPU); not a reference-parity recipe.

  python tools/train_src.py --config-path st.regda.tiny_smoke
"""

import os

import numpy as np

from regda_tpu_torch.configs._base import data_configs, prob_target_transforms

_ROOT = os.environ.get('REGDA_SMOKE_ROOT', '/tmp/regda_tiny_smoke')
_HW = 64
_C = 6


def _materialize():
    """Learnable synthetic tiles: each class has a distinct base color
    (domain-shifted between Potsdam/Vaihingen) + noise, so a real training
    run on this config actually converges — the smoke chain checks
    learning, not just plumbing. v2 marker invalidates older random data."""
    from PIL import Image
    marker = os.path.join(_ROOT, '.v2_learnable')
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(0)
    palette = (rng.integers(40, 215, (_C, 3)).astype(np.float32))
    shift = {'Potsdam': 0.0, 'Vaihingen': 25.0}
    for domain in ('Potsdam', 'Vaihingen'):
        for split, n in (('train', 4), ('val', 2), ('test', 2)):
            img_dir = os.path.join(_ROOT, domain, 'img_dir', split)
            ann_dir = os.path.join(_ROOT, domain, 'ann_dir', split)
            reg_dir = os.path.join(_ROOT, domain, 'reg_dir', split)
            for d in (img_dir, ann_dir, reg_dir):
                os.makedirs(d, exist_ok=True)
            for i in range(n):
                block = rng.integers(0, _C, (4, 4)).astype(np.uint8)
                lbl = np.kron(block, np.ones((_HW // 4, _HW // 4), np.uint8))
                img = palette[lbl] + shift[domain] \
                    + rng.normal(0, 12, (_HW, _HW, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                reg = np.kron(rng.integers(0, 5, (4, 4)),
                              np.ones((_HW // 4, _HW // 4))).astype(np.int32)
                Image.fromarray(img).save(os.path.join(img_dir, f't{i}.png'))
                Image.fromarray(lbl).save(os.path.join(ann_dir, f't{i}.png'))
                Image.fromarray(reg, mode='I').save(
                    os.path.join(reg_dir, f't{i}.tif'))
    open(marker, 'w').write('v2')


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
    crop=_HW, batch_size=2, num_workers=0)

MODEL = 'resnet18'
IGNORE_LABEL = -1
MOMENTUM = 0.9
SNAPSHOT_DIR = os.path.join(_ROOT, 'log')
WEIGHT_DECAY = 0.0005
LEARNING_RATE = 1e-2
_STEPS = int(os.environ.get('REGDA_SMOKE_STEPS', 6))
STAGE1_STEPS = _STEPS
STAGE2_STEPS = _STEPS
STAGE3_STEPS = _STEPS
NUM_STEPS = None
PREHEAT_STEPS = None
POWER = 0.9
EVAL_EVERY = _STEPS
GENE_EVERY = 6
CUTOFF_TOP = 0.8
CUTOFF_LOW = 0.6
PSEUDO_SELECT = True
CROP_SIZE = _HW

# prob-label target pipeline, like experiment_attrs (stages 1/2 override
# label_type/mask_dir the same way the real recipes do)
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
