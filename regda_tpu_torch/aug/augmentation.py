"""Joint RNG-explicit augmentations on numpy samples.

The port's copy of regda_tpu/aug/augmentation.py: the port imports nothing of the JAX package.

The reference carries two transform stacks — albumentations for id-label
loaders (configs/ToVaihingen.py:44-55) and a torch-tensor Compose for
prob-label loaders (regda/aug/augmentation.py:20-157). Here both collapse
into one numpy implementation: a sample dict {image HWC float32,
cls HW int | HWC float prob, sup HW int} is transformed jointly with an
explicit np.random.Generator (no hidden global state, reproducible per
worker).

Geometric keys: image/cls/sup all share crops/flips/rotations; Normalize
touches only the image. Stats are in 0-255 units with max_pixel_value=1
(i.e. NO 0-1 prescaling), matching the reference configs.
"""

from __future__ import annotations

import numpy as np

_GEO_KEYS = ('image', 'cls', 'sup')


def _apply_geo(sample: dict, fn) -> dict:
    out = dict(sample)
    for k in _GEO_KEYS:
        if k in out and isinstance(out[k], np.ndarray):
            out[k] = fn(out[k])
    return out


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class OneOf:
    """Apply one of `transforms` (uniformly chosen) with probability p.
    Unlike albumentations' OneOf, the chosen transform is invoked with its
    own prob — build inner transforms with always=True (as the shipped
    configs do) to get the albumentations force-apply semantics."""

    def __init__(self, transforms, p: float = 0.75):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() < self.p:
            t = self.transforms[rng.integers(len(self.transforms))]
            sample = t(sample, rng)
        return sample


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample, rng):
        h, w = sample['image'].shape[:2]
        th, tw = self.size
        y = int(rng.integers(0, h - th + 1))
        x = int(rng.integers(0, w - tw + 1))
        return _apply_geo(sample, lambda a: a[y:y + th, x:x + tw])


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample, rng):
        h, w = sample['image'].shape[:2]
        th, tw = self.size
        y, x = (h - th) // 2, (w - tw) // 2
        return _apply_geo(sample, lambda a: a[y:y + th, x:x + tw])


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5, always: bool = False):
        self.prob = 1.0 if always else prob

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            sample = _apply_geo(sample, lambda a: a[:, ::-1].copy())
        return sample


class RandomVerticalFlip:
    def __init__(self, prob: float = 0.5, always: bool = False):
        self.prob = 1.0 if always else prob

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            sample = _apply_geo(sample, lambda a: a[::-1].copy())
        return sample


class RandomRotate90:
    """fixed_k=None -> k drawn from 0..3 (albumentations semantics, used by
    the source OneOf stack); fixed_k=1 -> single 90-degree rotation with
    probability `prob` (the torch-tensor stack, regda/aug/augmentation.py:61-72)."""

    def __init__(self, prob: float = 0.5, always: bool = False, fixed_k=None):
        self.prob = 1.0 if always else prob
        self.fixed_k = fixed_k

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            k = int(rng.integers(0, 4)) if self.fixed_k is None else self.fixed_k
            if k:
                sample = _apply_geo(sample,
                                    lambda a: np.rot90(a, k=k, axes=(0, 1)).copy())
        return sample


class Normalize:
    """(img - mean) / std in 0-255 units (max_pixel_value=1); optional
    clamp(max=1.0) used by the prob-label stack (configs/st/regda/*.py)."""

    def __init__(self, mean, std, clamp: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.clamp = clamp

    def __call__(self, sample, rng):
        out = dict(sample)
        img = (out['image'] - self.mean) / self.std
        if self.clamp:
            img = np.minimum(img, 1.0)
        out['image'] = img.astype(np.float32)
        return out


class Resize:
    """Bilinear image / nearest label+region resize (reference
    regda/aug/augmentation.py:20-30)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample, rng):
        out = dict(sample)
        th, tw = self.size

        def resize(a, nearest):
            h, w = a.shape[:2]
            if (h, w) == (th, tw):
                return a
            yi = np.clip(((np.arange(th) + 0.5) * h / th).astype(np.int64),
                         0, h - 1)
            xi = np.clip(((np.arange(tw) + 0.5) * w / tw).astype(np.int64),
                         0, w - 1)
            if nearest:
                return a[yi][:, xi]
            # separable bilinear (half-pixel centers) in float32
            ys = (np.arange(th) + 0.5) * h / th - 0.5
            xs = (np.arange(tw) + 0.5) * w / tw - 0.5
            y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
            y1 = np.clip(y0 + 1, 0, h - 1)
            x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
            x1 = np.clip(x0 + 1, 0, w - 1)
            wy = np.clip(ys - y0, 0, 1)[:, None]
            wx = np.clip(xs - x0, 0, 1)[None, :]
            if a.ndim == 2:
                a = a[..., None]
            a = a.astype(np.float32)
            top = a[y0][:, x0] * (1 - wx[..., None]) + a[y0][:, x1] * wx[..., None]
            bot = a[y1][:, x0] * (1 - wx[..., None]) + a[y1][:, x1] * wx[..., None]
            r = top * (1 - wy[..., None]) + bot * wy[..., None]
            return r[..., 0] if r.shape[-1] == 1 and sample['image'].ndim == 2 else r

        if 'image' in out:
            out['image'] = resize(out['image'], nearest=False)
        for k in ('cls', 'sup'):
            if k in out and isinstance(out[k], np.ndarray):
                out[k] = resize(out[k], nearest=out[k].ndim == 2)
        return out


class Pad:
    """Constant-pad image (fill) and labels/regions (target fill)
    (reference regda/aug/augmentation.py:125-137). `padding_n` follows
    torchvision semantics: int = all sides, (l, t, r, b) = per side."""

    def __init__(self, padding_n, padding_fill_value=0,
                 padding_fill_target_value=0):
        if isinstance(padding_n, int):
            padding_n = (padding_n,) * 4
        self.pad = padding_n
        self.fill = padding_fill_value
        self.fill_t = padding_fill_target_value

    def __call__(self, sample, rng):
        out = dict(sample)
        l, t, r, b = self.pad

        def pad(a, fill):
            widths = [(t, b), (l, r)] + [(0, 0)] * (a.ndim - 2)
            return np.pad(a, widths, constant_values=fill)

        if 'image' in out:
            out['image'] = pad(out['image'], self.fill)
        for k in ('cls', 'sup'):
            if k in out and isinstance(out[k], np.ndarray):
                out[k] = pad(out[k], self.fill_t)
        return out
