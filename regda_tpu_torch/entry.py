"""Entry points of the port: the served eval forward, a few stage-2 steps,
SAM's encode and point-prompt decode, and SAM's everything-mode region
generator.

`entry()` is the counterpart of `__graft_entry__.entry()`: the DeepLabv2 /
ResNet-101 (C = 6) eval forward with seeded random weights, and example
arguments. `stage2_steps(n)` builds a stage-2 train state and runs `n` steps
of `train/steps.py:make_stage2_step` on seeded synthetic batches, with LRH
over ragged region maps, the path whose histogram is a CUDA kernel.
`sam_entry()` builds SAM with seeded random weights and example crops and
point prompts; its encoder runs the LayerNorm and attention CUDA kernels and
its fast decode (`Sam.decode_points_fast`) the two-way and mask-head ones.
`sam_regions_entry()` wraps such a SAM in a `SamRegionGenerator` at the
reference's everything-mode configuration and returns it with seeded tiles;
its region maps run all of SAM's kernels, the stability counts and the mask
statistics included.

Every entry point runs on the card (`device='cuda'`) unless the caller names
another device, and raises where no card is found: nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.models.sam.auto import Sam, SamRegionGenerator, build_point_grid
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.steps import make_stage2_step


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device='{device}'; the port's entry points run "
            f"on the card unless the caller asks for another device (device='cpu')")
    return device


def entry(device='cuda', *, batch: int = 1, dtype: torch.dtype = torch.float32):
    """-> (forward, example_args): forward(image (B, 512, 512, 3)) returns
    (B, 512, 512, 6) probabilities, computed in `dtype` with float32 weights."""
    device = _device(device)
    model = build_deeplabv2('ResNet101', num_classes=6, dtype=dtype,
                            generator=torch.Generator().manual_seed(0))
    model = model.to(device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def forward(image: torch.Tensor) -> torch.Tensor:
        return model(image)

    image = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, 512, 512, 3)).astype(np.float32)).to(device)
    return forward, (image,)


MAX_REGION_ID = 300   # a SAM everything-mode tile carries a few hundred regions


def synthetic_stage2_batch(rng: np.random.Generator, batch: int, size: int,
                           num_classes: int = 6):
    """Numpy stand-ins for one stage-2 batch: source images with 32x32-block
    labels (so the 16x majority vote keeps them), target images, and ragged
    region maps (ids 0..MAX_REGION_ID: a 16-px id grid overpainted with
    random rectangles, like SAM's overlapping masks)."""
    max_region_id = MAX_REGION_ID
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


def stage2_state(device='cuda', *, resnet: str = 'ResNet101', seed: int = 0):
    """A stage-2 train state from seeded random weights, with seeded normal
    prototypes standing in for a prototype checkpoint, and the stage-2 step
    (align_domain, refine_label and sam_refine on)."""
    device = _device(device)
    model = build_deeplabv2(resnet, num_classes=6,
                            generator=torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    protos = np.random.default_rng(seed).normal(
        size=(6, model.encoder.resnet.out_channels)).astype(np.float32)
    state = create_train_state(
        model, make_optimizer(model, 1e-2, stop_steps=6000),
        torch.Generator(device=device).manual_seed(seed), torch.from_numpy(protos))
    step = make_stage2_step(num_classes=6, align_domain=True,
                            refine_label=True, sam_refine=True)
    return state, step


def stage2_steps(n: int, device='cuda'):
    """Run `n` f32 stage-2 steps of ResNet-101 (see `stage2_state`) at the
    recipe's shape, 8 crops of 512^2 per domain (configs/st/regda/
    _experiment.py:35), on seeded synthetic batches. Returns (state, metrics
    per step, seconds per step); each step's time ends in a synchronize."""
    device = _device(device)
    state, step = stage2_state(device)
    rng = np.random.default_rng(1)
    metrics, seconds = [], []
    for _ in range(n):
        batch_np = synthetic_stage2_batch(rng, 8, 512)
        images_s, label_s, images_t, regs_t = (torch.from_numpy(a).to(device)
                                               for a in batch_np)
        t0 = time.perf_counter()
        metrics.append(step(state, images_s, label_s, images_t, regs_t))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return state, metrics, seconds


def _seeded_sam(device, vit_config: str, img_size: int, dtype: torch.dtype, seed: int) -> Sam:
    """SAM in eval mode on `device` with seeded random weights; the position
    tables, which a fresh model holds as zeros, are drawn too (std 0.02)."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = Sam(vit_config=vit_config, img_size=img_size, dtype=dtype)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if name.endswith(('pos_embed', 'rel_pos_h', 'rel_pos_w')):
                    param.normal_(std=0.02)
    return model.to(device).eval()


def sam_entry(device='cuda', *, vit_config: str = 'vit_b', img_size: int = 1024,
              crops: int = 5, points: int = 64,
              dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """-> (model, (images, points, labels)): SAM in eval mode with seeded
    random weights and float32 parameters, computing in `dtype`, and example
    arguments: `images` (crops, img_size, img_size, 3) normal noise standing
    in for preprocessed crops (one tile's 5-crop pyramid by default);
    `points` (points, 1, 2), the first prompts of the 32 x 32 everything-mode
    grid in input-image pixels; `labels` (points, 1) ones (foreground).
    `model.encode(images)` then `model.decode_points(emb[:1], points, labels)`
    is the path of `Sam.forward`; everything-mode decodes through
    `model.decode_points_fast(emb[:1], points, labels, mask_dtype=torch.bfloat16,
    blocked_masks=True)`, the fast path with the two-way and mask-head kernels.

    The position tables (`pos_embed`, `rel_pos_h`, `rel_pos_w`), which a
    fresh model holds as zeros, are drawn too (std 0.02), so that the bias
    path of the attention kernel carries values."""
    device = _device(device)
    model = _seeded_sam(device, vit_config, img_size, dtype, seed)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(crops, img_size, img_size, 3)).astype(np.float32)
    grid = build_point_grid(32)[:points] * img_size
    labels = np.ones((points, 1), np.float32)
    args = (images, grid[:, None, :], labels)
    return model, tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                        for a in args)


def sam_regions_entry(device='cuda', *, vit_config: str = 'vit_b', img_size: int = 1024,
                      tiles: int = 8, tile: int = 512, seed: int = 0,
                      dtype: torch.dtype = torch.bfloat16, **generator_kwargs):
    """-> (generator, tiles): a `SamRegionGenerator` over SAM with seeded
    random weights (as `sam_entry`), at the reference's everything-mode
    configuration (32 x 32 points, one crop layer with the grid halved, 256
    prompts a chunk, a budget of 256 masks a crop, thresholds 0.90 / 0.95;
    `generator_kwargs` override), and `tiles` seeded uint8 (tile, tile, 3)
    images. `generator.generate_regions_batch(tiles)` returns one int32
    (tile, tile) region map per tile."""
    device = _device(device)
    model = _seeded_sam(device, vit_config, img_size, dtype, seed)
    kwargs = dict(points_per_side=32, points_per_batch=256, pred_iou_thresh=0.90,
                  stability_score_thresh=0.95, crop_n_layers=1,
                  crop_n_points_downscale_factor=2, mask_budget=256)
    kwargs.update(generator_kwargs)
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, size=(tile, tile, 3), dtype=np.uint8) for _ in range(tiles)]
    return SamRegionGenerator(model, **kwargs), images
