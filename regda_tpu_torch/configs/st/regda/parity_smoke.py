"""Accuracy-parity smoke config: the trajectory testbed for PARITY.md.

Like tiny_smoke (self-contained synthetic ISPRS-style dataset), but built
so the adaptation machinery has measurable work to do — the rebuild's
substitute for the reference's metric-loop regression testing
(reference tools/train_src.py:151-163), since no real ISPRS data or
weights exist on this box:

  * a REAL domain gap: the target domain remaps class colors by blending
    the palette with a channel-rolled copy plus a brightness shift, so a
    source-only model transfers imperfectly and prototype alignment +
    pseudo-label self-training can demonstrably close the gap;
  * reg_dir maps aligned with the label cells (one region id per ground
    -truth cell, as SAM regions align with objects), so LRH's
    region-majority vote genuinely denoises pseudo-labels;
  * enough tiles/steps to separate the stages (REGDA_PARITY_STEPS,
    default 200/stage, eval every quarter).

Driven end-to-end by tools/run_parity.py which writes PARITY.md.
"""

import os

import numpy as np

from regda_tpu_torch.configs._base import data_configs, prob_target_transforms

_ROOT = os.environ.get('REGDA_PARITY_ROOT', '/tmp/regda_parity_smoke')
_HW = 64
_C = 6
_CELL = _HW // 4
# Domain-gap severity (palette-drift blend weight) and pixel-noise sigma.
# Defaults reproduce the original testbed. The strong-source LRH study
# (VERDICT round 2, item 2) uses a milder gap so stage 1 transfers well —
# the regime where the reference applies LRH (real ISPRS models sit at
# ~0.5+ mIoU) — plus the same in-region pixel noise for LRH to clean up.
_GAP = float(os.environ.get('REGDA_PARITY_GAP', '0.45'))
_NOISE = float(os.environ.get('REGDA_PARITY_NOISE', '14'))
# Salt corruption: fraction of pixels replaced by uniform random colors.
# Gaussian noise shifts every pixel a little (the model's errors stay
# spatially coherent per cell — a regime LRH cannot fix, since the
# region-majority vote inherits the coherent error); salt corrupts a
# scattered MINORITY of pixels severely. Those pixels are unclassifiable
# alone (low confidence -> dropped by pseudo_selection) while the clean
# majority in the same SAM region votes the true class — the
# scattered-error regime the reference's Homogenizer targets
# (local_region_homog.py:99-152).
_SALT = float(os.environ.get('REGDA_PARITY_SALT', '0'))


def _materialize():
    from PIL import Image
    salt_tag = f'_s{_SALT}' if _SALT else ''
    marker = os.path.join(_ROOT, f'.v1_parity_g{_GAP}_n{_NOISE}{salt_tag}')
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(7)
    palette = rng.integers(40, 215, (_C, 3)).astype(np.float32)
    # target classes keep partial identity but drift: channel roll +
    # brightness shift, both scaled by the gap knob (gap 0.45 = original)
    palette_t = ((1.0 - _GAP) * palette + _GAP * np.roll(palette, 1, axis=-1)
                 + 28.0 * (_GAP / 0.45))
    domains = {'Potsdam': palette, 'Vaihingen': palette_t}
    for domain, pal in domains.items():
        for split, n in (('train', 16), ('val', 4), ('test', 4)):
            img_dir = os.path.join(_ROOT, domain, 'img_dir', split)
            ann_dir = os.path.join(_ROOT, domain, 'ann_dir', split)
            reg_dir = os.path.join(_ROOT, domain, 'reg_dir', split)
            for d in (img_dir, ann_dir, reg_dir):
                os.makedirs(d, exist_ok=True)
            for i in range(n):
                block = rng.integers(0, _C, (4, 4)).astype(np.uint8)
                lbl = np.kron(block, np.ones((_CELL, _CELL), np.uint8))
                img = pal[lbl] + rng.normal(0, _NOISE, (_HW, _HW, 3))
                if _SALT:
                    corrupt = rng.random((_HW, _HW)) < _SALT
                    img = np.where(corrupt[..., None],
                                   rng.uniform(0, 255, (_HW, _HW, 3)), img)
                img = np.clip(img, 0, 255).astype(np.uint8)
                # regions aligned with the label grid: unique id per cell
                # (ids 1..16; 0 = unassigned kept out, like SAM's packing)
                cell_ids = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
                reg = np.kron(cell_ids,
                              np.ones((_CELL, _CELL), np.int32))
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
    crop=_HW, batch_size=4, num_workers=0)

MODEL = 'resnet18'
IGNORE_LABEL = -1
MOMENTUM = 0.9
SNAPSHOT_DIR = os.path.join(
    _ROOT, 'log' + os.environ.get('REGDA_PARITY_TAG', ''))
WEIGHT_DECAY = 0.0005
LEARNING_RATE = 1e-2
_STEPS = int(os.environ.get('REGDA_PARITY_STEPS', 200))
STAGE1_STEPS = _STEPS
STAGE2_STEPS = _STEPS
STAGE3_STEPS = _STEPS
NUM_STEPS = None
PREHEAT_STEPS = None
POWER = 0.9
EVAL_EVERY = max(_STEPS // 4, 1)
GENE_EVERY = _STEPS
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
    batch_size=4,
    num_workers=0,
    label_type='prob',
    read_sup=True,
)

# pseudo-label maps must match the synthetic tile size (the reference
# default, the dataset meta SIZE, only equals the tile size on real data)
PSEUDO_SIZE = (_HW, _HW)
