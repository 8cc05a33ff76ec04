"""Vaihingen IRRG -> Potsdam domain pair (reference configs/ToPotsdam.py)."""

from regda_tpu_torch.configs._base import data_configs, IMAGENET_STATS

DATASETS = 'IsprsDA'
TARGET_SET = 'Potsdam'

source_dir = dict(image_dir=['data/IsprsDA/Vaihingen/img_dir/train'],
                  mask_dir=['data/IsprsDA/Vaihingen/ann_dir/train'])
target_dir = dict(image_dir=['data/IsprsDA/Potsdam/img_dir/train'],
                  mask_dir=['data/IsprsDA/Potsdam/ann_dir/train'])
val_dir = dict(image_dir=['data/IsprsDA/Potsdam/img_dir/val'],
               mask_dir=['data/IsprsDA/Potsdam/ann_dir/val'])
test_dir = dict(image_dir=['data/IsprsDA/Potsdam/img_dir/test'],
                mask_dir=['data/IsprsDA/Potsdam/ann_dir/test'])

TARGET_STATS = IMAGENET_STATS

(SOURCE_DATA_CONFIG, TARGET_DATA_CONFIG, PSEUDO_DATA_CONFIG,
 EVAL_DATA_CONFIG, TEST_DATA_CONFIG) = data_configs(
    source_dir, target_dir, val_dir, test_dir,
    IMAGENET_STATS, IMAGENET_STATS)
