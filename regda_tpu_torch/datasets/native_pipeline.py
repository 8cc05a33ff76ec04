"""Native fast path for the data loader: mirror the Python transform
stack's RNG draws, then hand decode + fused geometry + normalize to the C++
pipeline (regda_tpu_torch/native/regda_native.cpp). The port's copy of
regda_tpu/datasets/native_pipeline.py.

Both paths consume identical RNG decisions, so a batch from the native path
is bit-identical to the pure-Python one (tests/test_torch_data.py). Supported
stacks are the ones the configs build (configs/_base.py): an optional
Random/CenterCrop, then flips/rot90 (possibly inside OneOf) in
crop -> hflip -> vflip -> rot90 order, then Normalize. Anything else (e.g.
prob-label float masks) falls back to Python.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

from regda_tpu_torch import native
from regda_tpu_torch.aug.augmentation import (CenterCrop, Compose, Normalize, OneOf,
                                        RandomCrop, RandomHorizontalFlip,
                                        RandomRotate90, RandomVerticalFlip)


def native_enabled() -> bool:
    if os.environ.get('REGDA_NATIVE', '1') == '0':
        return False
    return native.available()


def draw_geo_params(transforms, rng: np.random.Generator, h: int, w: int
                    ) -> Optional[dict]:
    """Replay the transform stack's RNG consumption and return the flat
    geometry + normalization parameters, or None if the stack has a shape
    the native kernel doesn't cover.

    MUST stay in lockstep with regda_tpu_torch/aug/augmentation.py: each branch
    consumes exactly the draws the corresponding transform would.
    """
    if not isinstance(transforms, Compose):
        return None
    crop = None
    x0 = y0 = 0
    hflip = vflip = rotk = 0
    mean = std = None
    clamp = False
    # enforce canonical order: crop(0) -> hflip(1) -> vflip(2) -> rot(3) -> norm(4)
    stage = -1

    def advance(s):
        nonlocal stage
        if s < stage:
            raise ValueError
        stage = s

    def handle(t):
        nonlocal crop, x0, y0, hflip, vflip, rotk, mean, std, clamp
        if isinstance(t, RandomCrop):
            advance(0)
            th, tw = t.size
            if th != tw:
                raise ValueError
            crop = th
            y0 = int(rng.integers(0, h - th + 1))
            x0 = int(rng.integers(0, w - tw + 1))
        elif isinstance(t, CenterCrop):
            advance(0)
            th, tw = t.size
            if th != tw:
                raise ValueError
            crop = th
            y0, x0 = (h - th) // 2, (w - tw) // 2
        elif isinstance(t, RandomHorizontalFlip):
            advance(1)
            if rng.random() < t.prob:
                hflip = 1
        elif isinstance(t, RandomVerticalFlip):
            advance(2)
            if rng.random() < t.prob:
                vflip = 1
        elif isinstance(t, RandomRotate90):
            advance(3)
            if rng.random() < t.prob:
                k = int(rng.integers(0, 4)) if t.fixed_k is None else t.fixed_k
                rotk = k
        elif isinstance(t, OneOf):
            # one sub-transform applied at most; order constraint is safe
            if rng.random() < t.p:
                handle(t.transforms[int(rng.integers(len(t.transforms)))])
        elif isinstance(t, Normalize):
            advance(4)
            mean = np.broadcast_to(t.mean, (3,)).astype(np.float32)
            std = np.broadcast_to(t.std, (3,)).astype(np.float32)
            clamp = t.clamp
        else:
            raise ValueError

    try:
        for t in transforms.transforms:
            handle(t)
    except ValueError:
        return None
    if mean is None:
        mean = np.zeros(3, np.float32)
        std = np.ones(3, np.float32)
    if crop is None:
        crop = min(h, w)  # no crop: only valid when square input
        if h != w:
            return None
    return dict(params=np.array([x0, y0, crop, hflip, vflip, rotk], np.int32),
                mean=mean, std=std, clamp=clamp, crop=crop)


def try_native_batch(dataset, indices, rngs, nthreads: int = 4
                     ) -> Optional[dict]:
    """Load a whole batch through the native pipeline; None -> caller falls
    back to the per-sample Python path.

    `dataset` is a TileDataset with label_type='id' and PNG tiles; rngs is
    one np.random.Generator per sample (same seeds as the Python path).
    """
    if dataset.label_type != 'id' or not native_enabled():
        return None
    img_paths = [dataset.rgb_paths[i] for i in indices]
    if not all(p.endswith('.png') for p in img_paths):
        return None

    # every tile must share one size: the RNG draws below use (h, w), and a
    # silently different tile would skew the crop distribution vs the
    # Python path (PIL reads only the header here — cheap)
    sizes = set()
    for p in img_paths:
        with Image.open(p) as im:
            sizes.add(im.size)
    if len(sizes) != 1:
        return None
    w, h = sizes.pop()

    per = []
    for rng in rngs:
        p = draw_geo_params(dataset.transforms, rng, h, w)
        if p is None:
            return None
        per.append(p)
    crop = per[0]['crop']
    params = np.stack([p['params'] for p in per])

    mask_paths = None
    if dataset.cls_paths:
        mask_paths = [dataset.cls_paths[i] for i in indices]
        if not all(p.endswith('.png') for p in mask_paths):
            return None
    sups = None
    if dataset.read_sup:
        sups = [np.asarray(Image.open(dataset.sup_paths[i])).astype(np.int32)
                for i in indices]
        # the C++ kernel indexes sup with image coordinates; a size-mismatched
        # region map would read out of bounds — fall back to Python instead
        if any(s.shape != (h, w) for s in sups):
            return None

    try:
        img, mask, sup = native.load_batch(
            img_paths, mask_paths, sups, params,
            per[0]['mean'], per[0]['std'], per[0]['clamp'],
            dataset.meta.offset, dataset.meta.num_classes,
            dataset.meta.ignore_label, crop, nthreads=nthreads)
    except IOError:
        # decode failure or per-tile size mismatch: Python path handles it
        return None
    out = {'image': img,
           'fname': [os.path.basename(p) for p in img_paths]}
    if mask is not None:
        out['cls'] = mask
    if sup is not None:
        out['sup'] = sup
    return out
