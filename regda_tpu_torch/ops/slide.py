"""Sliding-window inference with count-normalized probability accumulation
(counterpart of regda_tpu/ops/slide.py).

Parity target: regda/utils/tools.py:61-97 (`pre_slide`): 512-pixel tiles,
50 % overlap, end-aligned edge tiles, per-tile eval forward, the sum of
probabilities divided by visit counts. All tiles go to `apply_fn` as one
batch (tile-major: tile i of every image, then tile i + 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.tta import tta_apply


def tile_positions(h: int, w: int, tile: int, stride: int) -> list[tuple[int, int]]:
    """Top-left corners (y, x) of the tiles over an h x w image, row by row;
    the last row and column end at the image's edge."""
    rows = int(math.ceil(max(h - tile, 0) / stride) + 1)
    cols = int(math.ceil(max(w - tile, 0) / stride) + 1)
    pos = []
    for r in range(rows):
        for c in range(cols):
            y2 = min(r * stride + tile, h)
            x2 = min(c * stride + tile, w)
            pos.append((max(y2 - tile, 0), max(x2 - tile, 0)))
    return pos


def slide_inference(apply_fn, image: torch.Tensor, num_classes: int,
                    tile: int = 512, stride: int = 256,
                    tta: bool = False) -> torch.Tensor:
    """apply_fn: (N, tile, tile, 3) -> (N, tile, tile, C) probs; image
    (B, H, W, 3), zero-padded at the bottom and right where smaller than a
    tile. Returns (B, H, W, C) count-normalized probabilities."""
    b, h, w, _ = image.shape
    pad_h, pad_w = max(tile - h, 0), max(tile - w, 0)
    if pad_h or pad_w:
        image = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    pos = tile_positions(hp, wp, tile, stride)

    tiles = torch.cat([image[:, y:y + tile, x:x + tile] for y, x in pos])
    probs = tta_apply(apply_fn, tiles) if tta else apply_fn(tiles)

    full = torch.zeros((b, hp, wp, num_classes), dtype=probs.dtype, device=probs.device)
    count = torch.zeros((1, hp, wp, 1), dtype=probs.dtype, device=probs.device)
    for i, (y, x) in enumerate(pos):
        full[:, y:y + tile, x:x + tile] += probs[i * b:(i + 1) * b]
        count[:, y:y + tile, x:x + tile] += 1.0
    return (full / count)[:, :h, :w]
