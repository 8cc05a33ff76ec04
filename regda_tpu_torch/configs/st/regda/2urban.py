"""RegDA experiment config (reference configs/st/regda/2urban.py)."""

from regda_tpu_torch.configs.ToURBAN import (SOURCE_DATA_CONFIG, EVAL_DATA_CONFIG,
                        PSEUDO_DATA_CONFIG, TEST_DATA_CONFIG, TARGET_SET,
                        TARGET_STATS, target_dir, DATASETS)
from regda_tpu_torch.configs.st.regda._experiment import experiment_attrs

globals().update(experiment_attrs(
    model='ResNet',
    snapshot_dir='./log/regda/2urban',
    target_dir=target_dir,
    target_stats=TARGET_STATS,
    clamp=False,
))
