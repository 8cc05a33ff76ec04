"""Potsdam RGB -> Vaihingen variant (reference configs/st/regda/
pRgb2vaihingen.py): source tiles from the RGB-channel Potsdam tree; the
reference normalizes the RGB source with the Vaihingen stats (:27-28)."""

from regda_tpu_torch.configs.ToVaihingen import (EVAL_DATA_CONFIG, PSEUDO_DATA_CONFIG,
                                 TEST_DATA_CONFIG, TARGET_SET, target_dir,
                                 DATASETS)
from regda_tpu_torch.configs._base import VAIHINGEN_STATS, train_transforms
from regda_tpu_torch.configs.st.regda._experiment import experiment_attrs

source_dir = dict(image_dir=['data/IsprsDA/Potsdam_rgb/img_dir/train'],
                  mask_dir=['data/IsprsDA/Potsdam_rgb/ann_dir/train'])

SOURCE_DATA_CONFIG = dict(
    image_dir=source_dir['image_dir'],
    mask_dir=source_dir['mask_dir'],
    transforms=train_transforms(*VAIHINGEN_STATS),
    CV=dict(k=10, i=-1), training=True, batch_size=8, num_workers=4)

globals().update(experiment_attrs(
    model='ResNet101',
    snapshot_dir='./log/regda/pRgb2vaihingen',
    target_dir=target_dir,
    target_stats=VAIHINGEN_STATS,
    clamp=True,
))
