"""LoveDA Rural -> Urban domain pair (reference configs/ToURBAN.py)."""

from regda_tpu_torch.configs._base import data_configs, LOVEDA_STATS

DATASETS = 'LoveDA'
TARGET_SET = 'Urban'

source_dir = dict(image_dir=['data/LoveDA/Train/Rural/images_png'],
                  mask_dir=['data/LoveDA/Train/Rural/masks_png'])
target_dir = dict(image_dir=['data/LoveDA/Val/Urban/images_png'],
                  mask_dir=[None])
val_dir = dict(image_dir=['data/LoveDA/Train/Urban/images_png'],
               mask_dir=['data/LoveDA/Train/Urban/masks_png'])
test_dir = dict(image_dir=['data/LoveDA/Test/Urban/images_png'],
                mask_dir=[None])

TARGET_STATS = LOVEDA_STATS

(SOURCE_DATA_CONFIG, TARGET_DATA_CONFIG, PSEUDO_DATA_CONFIG,
 EVAL_DATA_CONFIG, TEST_DATA_CONFIG) = data_configs(
    source_dir, target_dir, val_dir, test_dir,
    LOVEDA_STATS, LOVEDA_STATS)
