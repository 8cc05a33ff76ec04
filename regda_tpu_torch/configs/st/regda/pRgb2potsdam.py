"""Potsdam RGB -> Potsdam IRRG variant (reference configs/st/regda/
pRgb2potsdam.py): RGB-channel Potsdam tiles as the SOURCE (ImageNet
normalization, :26-27), target/eval/test on the Potsdam IRRG trees from
ToPotsdam."""

from regda_tpu_torch.configs.ToPotsdam import (EVAL_DATA_CONFIG, PSEUDO_DATA_CONFIG,
                               TEST_DATA_CONFIG, TARGET_SET, target_dir,
                               TARGET_STATS, DATASETS)
from regda_tpu_torch.configs._base import IMAGENET_STATS, train_transforms
from regda_tpu_torch.configs.st.regda._experiment import experiment_attrs

source_dir = dict(image_dir=['data/IsprsDA/Potsdam_rgb/img_dir/train'],
                  mask_dir=['data/IsprsDA/Potsdam_rgb/ann_dir/train'])

SOURCE_DATA_CONFIG = dict(
    image_dir=source_dir['image_dir'],
    mask_dir=source_dir['mask_dir'],
    transforms=train_transforms(*IMAGENET_STATS),
    CV=dict(k=10, i=-1), training=True, batch_size=8, num_workers=4)

globals().update(experiment_attrs(
    model='ResNet101',
    snapshot_dir='./log/regda/pRgb2potsdam',
    target_dir=target_dir,
    target_stats=TARGET_STATS,
    clamp=True,
))
