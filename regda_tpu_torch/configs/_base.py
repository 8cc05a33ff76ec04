"""Shared constructors of the domain-pair data configs.

Mirrors the structure of the reference's configs/To*.py files
(the reference's configs/ToVaihingen.py:41-127 etc.): five *_DATA_CONFIG
dicts per domain pair, each carrying dirs + joint transforms + loader
options. Transform stacks use regda_tpu_torch.aug (numpy, RNG-explicit) instead
of albumentations/torchvision; stats stay in 0-255 units
(max_pixel_value=1 semantics).
"""

from regda_tpu_torch.aug import (Compose, OneOf, RandomCrop, RandomHorizontalFlip,
                           RandomVerticalFlip, RandomRotate90, Normalize)


def train_transforms(mean, std, crop=512):
    return Compose([
        RandomCrop(crop),
        OneOf([
            RandomHorizontalFlip(always=True),
            RandomVerticalFlip(always=True),
            RandomRotate90(always=True),
        ], p=0.75),
        Normalize(mean=mean, std=std),
    ])


def eval_transforms(mean, std):
    return Compose([Normalize(mean=mean, std=std)])


def prob_target_transforms(mean, std, crop=512, clamp=True):
    """The tensor-pipeline stack for prob-label target loaders
    (configs/st/regda/2vaihingen.py:30-40)."""
    return Compose([
        RandomCrop(crop),
        RandomHorizontalFlip(0.5),
        RandomVerticalFlip(0.5),
        RandomRotate90(0.5, fixed_k=1),
        Normalize(mean=mean, std=std, clamp=clamp),
    ])


def data_configs(source_dir, target_dir, val_dir, test_dir,
                 source_stats, target_stats, crop=512,
                 batch_size=8, num_workers=4):
    src_mean, src_std = source_stats
    tgt_mean, tgt_std = target_stats
    cv = dict(k=10, i=-1)
    source = dict(image_dir=source_dir['image_dir'],
                  mask_dir=source_dir['mask_dir'],
                  transforms=train_transforms(src_mean, src_std, crop),
                  CV=cv, training=True, batch_size=batch_size,
                  num_workers=num_workers)
    target = dict(image_dir=target_dir['image_dir'],
                  mask_dir=target_dir['mask_dir'],
                  transforms=train_transforms(tgt_mean, tgt_std, crop),
                  CV=cv, training=True, batch_size=batch_size,
                  num_workers=num_workers)
    pseudo = dict(image_dir=target_dir['image_dir'],
                  mask_dir=target_dir['mask_dir'],
                  transforms=eval_transforms(tgt_mean, tgt_std),
                  CV=cv, training=False, batch_size=1, num_workers=1)
    evalc = dict(image_dir=val_dir['image_dir'], mask_dir=val_dir['mask_dir'],
                 transforms=eval_transforms(tgt_mean, tgt_std),
                 CV=cv, training=False, batch_size=1, num_workers=1)
    testc = dict(image_dir=test_dir['image_dir'], mask_dir=test_dir['mask_dir'],
                 transforms=eval_transforms(tgt_mean, tgt_std),
                 CV=cv, training=False, batch_size=1, num_workers=1)
    return source, target, pseudo, evalc, testc


# normalization stats (0-255 units) — reference configs/To*.py
POTSDAM_IRRG_STATS = ((97.4603, 86.3828, 92.4078), (36.2062, 35.7308, 35.3348))
VAIHINGEN_STATS = ((120.8217, 81.8250, 81.2344), (54.7461, 39.3116, 37.9288))
IMAGENET_STATS = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
LOVEDA_STATS = ((73.53223948, 80.01710095, 74.59297778),
                (41.5113661, 35.66528876, 33.75830885))
