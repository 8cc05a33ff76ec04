"""Shared experiment hyper-parameters for the regda recipes
(reference configs/st/regda/2vaihingen.py:6-48 etc.)."""

from regda_tpu_torch.configs._base import prob_target_transforms


def experiment_attrs(model: str, snapshot_dir: str, target_dir: dict,
                     target_stats, clamp: bool = True):
    """Returns the ALL_CAPS attribute dict each experiment config exposes."""
    mean, std = target_stats
    return dict(
        MODEL=model,
        IGNORE_LABEL=-1,
        MOMENTUM=0.9,
        SNAPSHOT_DIR=snapshot_dir,
        WEIGHT_DECAY=0.0005,
        LEARNING_RATE=1e-2,
        STAGE1_STEPS=4000,
        STAGE2_STEPS=6000,
        STAGE3_STEPS=6000,
        NUM_STEPS=None,       # filled as stop_steps * 1.5 per stage
        PREHEAT_STEPS=None,   # filled as stop_steps / 20 per stage
        POWER=0.9,
        EVAL_EVERY=500,
        GENE_EVERY=1000,
        CUTOFF_TOP=0.8,
        CUTOFF_LOW=0.6,
        PSEUDO_SELECT=True,
        TARGET_DATA_CONFIG=dict(
            image_dir=target_dir['image_dir'],
            mask_dir=[None],
            transforms=prob_target_transforms(mean, std, clamp=clamp),
            CV=dict(k=10, i=-1),
            training=True,
            batch_size=8,
            num_workers=4,
            label_type='prob',
            read_sup=True,
        ),
    )
