"""Dihedral test-time augmentation (counterpart of regda_tpu/ops/tta.py).

Parity target: regda/utils/tools.py:132-152 (`tta_predict` with ttach
HorizontalFlip x Rotate90[0, 90, 180, 270], the 8-element dihedral group),
averaging the de-augmented probability maps. The 8 variants are stacked
into the batch, so the model runs once at 8x the batch.
"""

from __future__ import annotations

import torch

# (hflip, k-rot90) for the 8 dihedral elements
DIHEDRAL = [(False, 0), (False, 1), (False, 2), (False, 3),
            (True, 0), (True, 1), (True, 2), (True, 3)]


def _aug(x: torch.Tensor, hflip: bool, k: int) -> torch.Tensor:
    if hflip:
        x = torch.flip(x, dims=(2,))
    return torch.rot90(x, k, dims=(1, 2)) if k else x


def _deaug(x: torch.Tensor, hflip: bool, k: int) -> torch.Tensor:
    if k:
        x = torch.rot90(x, -k, dims=(1, 2))
    return torch.flip(x, dims=(2,)) if hflip else x


def tta_apply(apply_fn, image: torch.Tensor) -> torch.Tensor:
    """apply_fn: (N, H, W, 3) -> (N, H, W, C) probs; image (B, H, W, 3).
    Returns the mean of the 8 de-augmented probability maps."""
    b = image.shape[0]
    probs = apply_fn(torch.cat([_aug(image, f, k) for f, k in DIHEDRAL]))
    out = _deaug(probs[:b], *DIHEDRAL[0])
    for i, (f, k) in enumerate(DIHEDRAL[1:], 1):
        out = out + _deaug(probs[i * b:(i + 1) * b], f, k)
    return out / len(DIHEDRAL)
