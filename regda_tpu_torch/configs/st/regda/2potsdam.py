"""RegDA experiment config (reference configs/st/regda/2potsdam.py)."""

from regda_tpu_torch.configs.ToPotsdam import (SOURCE_DATA_CONFIG, EVAL_DATA_CONFIG,
                        PSEUDO_DATA_CONFIG, TEST_DATA_CONFIG, TARGET_SET,
                        TARGET_STATS, target_dir, DATASETS)
from regda_tpu_torch.configs.st.regda._experiment import experiment_attrs

globals().update(experiment_attrs(
    model='ResNet101',
    snapshot_dir='./log/regda/2potsdam',
    target_dir=target_dir,
    target_stats=TARGET_STATS,
    clamp=True,
))
