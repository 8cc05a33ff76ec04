"""Plain PyTorch reference of RegDA's evaluation with test-time augmentation
(regda/utils/tools.py: `pre_slide` over 512-pixel windows at half overlap
with end-aligned edge windows, each window's probabilities the mean over
the 8 elements of the dihedral group, horizontal flip x rotations by 0,
90, 180 and 270 degrees, undone before the mean; overlapping windows
averaged by their visit counts). The model is the plain reference in eval
mode, BatchNorm from its running statistics: nothing is folded or fused.
"""

from __future__ import annotations

import math

import torch

DIHEDRAL = [(f, k) for f in (False, True) for k in range(4)]


def tta_probs(model, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, h, w) -> (B, C, h, w), the mean of the 8 views' probabilities."""
    total = 0.0
    for flip, k in DIHEDRAL:
        v = torch.flip(x, (3,)) if flip else x
        p = model(torch.rot90(v, k, (2, 3)))
        p = torch.rot90(p, -k, (2, 3))
        total = total + (torch.flip(p, (3,)) if flip else p)
    return total / len(DIHEDRAL)


def window_corners(n: int, tile: int, stride: int) -> list:
    steps = math.ceil(max(n - tile, 0) / stride) + 1
    return [max(min(i * stride + tile, n) - tile, 0) for i in range(steps)]


@torch.no_grad()
def slide_tta_probs(model, image: torch.Tensor, num_classes: int, tile: int,
                    stride: int) -> torch.Tensor:
    """image (1, H, W, 3) float32 -> (1, C, H, W) probabilities."""
    x = image.permute(0, 3, 1, 2)
    _, _, h, w = x.shape
    ph, pw = max(tile - h, 0), max(tile - w, 0)
    x = torch.nn.functional.pad(x, (0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    total = torch.zeros((1, num_classes, hp, wp), device=x.device)
    count = torch.zeros((1, 1, hp, wp), device=x.device)
    for y in window_corners(hp, tile, stride):
        for x0 in window_corners(wp, tile, stride):
            total[..., y:y + tile, x0:x0 + tile] += tta_probs(
                model, x[..., y:y + tile, x0:x0 + tile])
            count[..., y:y + tile, x0:x0 + tile] += 1
    return (total / count)[..., :h, :w]


def widest_gap(probs: torch.Tensor, labels: torch.Tensor) -> float:
    """probs (1, C, H, W), labels (H, W): the widest gap by which the
    probability of a served label lies below the best class's."""
    chosen = probs[0].gather(0, labels.long()[None])[0]
    return float((probs[0].amax(0) - chosen).max())
