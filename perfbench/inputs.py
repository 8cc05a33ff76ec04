"""What the benchmark makes from `--seed` and hands to both the program and
the reference: the segmenter's weights, the stage-2 batches and the eval
tiles. Nothing here imports the program.

`stage2_batch` is a frozen copy of the port's `entry.synthetic_stage2_batch`
(regda_tpu_torch/entry.py), so that a change to the program cannot change
the traffic it is measured on.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(2, np.uint32)
               .astype(np.uint64) @ np.array([1, 2**32], np.uint64)) % 2**63


def seeded_weights(shapes: dict, seed: int, device) -> dict:
    """A state_dict over `shapes` (name -> shape, the reference's key names)
    drawn on `device` in two calls of one generator: every conv kernel
    LeCun-normal (std 1/sqrt(fan in)), every BatchNorm scale 1 and bias 0,
    each classifier bias 0, and each BatchNorm's running mean normal with
    std 0.1 and running variance uniform in [0.5, 2), as a trained model's
    statistics would move the folded weights."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    means = [k for k in shapes if k.endswith('running_mean')]
    n_normal = sum(math.prod(shapes[k]) for k in kernels + means)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in shapes if k.endswith('running_var')),
                         generator=g, device=device)
    out, i, j = {}, 0, 0
    for k, s in shapes.items():
        n = math.prod(s)
        if len(s) == 4:
            out[k] = normal[i:i + n].view(s) / math.sqrt(math.prod(s[1:]))
            i += n
        elif k.endswith('running_mean'):
            out[k] = 0.1 * normal[i:i + n].view(s)
            i += n
        elif k.endswith('running_var'):
            out[k] = 0.5 + 1.5 * uniform[j:j + n].view(s)
            j += n
        elif k.endswith('weight'):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def seeded_prototypes(num_classes: int, dim: int, seed: int) -> np.ndarray:
    """(C, K) float32 normal prototypes standing in for init_prototypes' file."""
    return np.random.default_rng(sub_seed(seed, 1)).normal(
        size=(num_classes, dim)).astype(np.float32)


def stage2_batch(rng: np.random.Generator, batch: int, size: int, num_classes: int,
                 max_region_id: int):
    """Numpy stand-ins for one stage-2 batch: source images with 32x32-block
    labels (so the 16x majority vote keeps them), target images, and ragged
    region maps (ids 0..max_region_id: a 16-px id grid overpainted with
    random rectangles, like SAM's overlapping masks)."""
    images_s = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    block = rng.integers(0, num_classes, size=(batch, size // 32, size // 32))
    label_s = np.kron(block, np.ones((32, 32), np.int64)).astype(np.int32)
    images_t = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    regs = np.kron(rng.integers(0, max_region_id + 1, size=(batch, size // 16, size // 16)),
                   np.ones((16, 16), np.int64)).astype(np.int32)
    for b in range(batch):
        for _ in range(max(1, max_region_id // 4)):
            y0, x0 = rng.integers(0, size, size=2)
            h, w = rng.integers(size // 32 + 1, size // 4 + 2, size=2)
            regs[b, y0:y0 + h, x0:x0 + w] = rng.integers(0, max_region_id + 1)
    return images_s, label_s, images_t, regs


def stage2_pool(seed: int, count: int, batch: int, size: int, num_classes: int,
                max_region_id: int) -> list:
    """`count` distinct stage-2 batches from the seed: every row differs."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    return [stage2_batch(rng, batch, size, num_classes, max_region_id) for _ in range(count)]


def eval_tiles(seed: int, count: int, size: int, mean, std) -> list:
    """`count` seeded uint8 RGB tiles normalised by the target's statistics
    as the eval loader gives them: (1, size, size, 3) float32 each."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return [((rng.integers(0, 256, size=(1, size, size, 3), dtype=np.uint8)
              .astype(np.float32) - mean) / std) for _ in range(count)]
