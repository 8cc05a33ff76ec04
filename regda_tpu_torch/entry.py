"""Entry points of the port: the served eval forward, the segmentation
inferencer, a few stage-2 steps, SAM's encode and point-prompt decode, and
SAM's everything-mode region generator.

`entry()` is the counterpart of `__graft_entry__.entry()`: the DeepLabv2 /
ResNet-101 (C = 6) eval forward with seeded random weights, and example
arguments. `serve_entry()` wraps such a model, with seeded BatchNorm
statistics too, in the `SegInferencer` that evaluation and single-image
prediction go through (BN folding and the fused dual-PPM forward on).
`stage2_steps(n)` builds a stage-2 train state and runs `n` steps
of `train/steps.py:make_stage2_step` on seeded synthetic batches, with LRH
over ragged region maps, the path whose histogram is a CUDA kernel;
`stage3_steps(n)` does the same for `make_stage3_step`, on seeded soft
pseudo-labels; both take `remat=True` for per-block gradient checkpointing,
and `after_step`, called with each step's index and the state.
`sam_entry()` builds SAM with seeded random weights and example crops and
point prompts; its encoder runs the LayerNorm and attention CUDA kernels and
its fast decode (`Sam.decode_points_fast`) the two-way and mask-head ones.
`sam_regions_entry()` wraps such a SAM in a `SamRegionGenerator` at the
reference's everything-mode configuration and returns it with seeded tiles;
its region maps run all of SAM's kernels, the stability counts and the mask
statistics included.

`dryrun_data_parallel(n)` is the counterpart of
`__graft_entry__.dryrun_multichip` on the 'data' axis: n ranks run one
stage-2 step on their rows of a global batch and are held to the
one-process step on the whole batch.

Every entry point runs on the card (`device='cuda'`) unless the caller names
another device, and raises where no card is found: nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.models.resnet import BatchNorm2d
from regda_tpu_torch.models.sam.auto import Sam, SamRegionGenerator, build_point_grid
from regda_tpu_torch.parallel.mesh import shard_batch
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.steps import make_stage2_step, make_stage3_step


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


@torch.no_grad()
def seed_bn_statistics(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every BatchNorm's running mean (normal, std 0.1) and variance
    (uniform in [0.5, 2)) from `generator`, so that folding them moves the
    weights as a trained model's statistics would (a fresh model holds 0 / 1)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=generator))
            m.running_var.copy_(0.5 + 1.5 * torch.rand(m.running_var.shape, generator=generator))


def serve_entry(device='cuda', *, dtype: torch.dtype = torch.bfloat16,
                resnet: str = 'ResNet101', images: int = 16, size: int = 512,
                tile: int = 512, stride: int = 256, fold_bn: bool | None = None):
    """-> (inferencer, images): a `SegInferencer` over DeepLabv2 (`resnet`,
    C = 6) with seeded random weights and BatchNorm statistics, float32
    parameters computing in `dtype`, at `tile` / `stride`; and `images`
    seeded normal (images, size, size, 3) float32 numpy images. The default
    folds the BNs and fuses the heads; `fold_bn=False` serves the stock
    forward of the same weights."""
    device = _device(device)
    generator = torch.Generator().manual_seed(0)
    model = build_deeplabv2(resnet, num_classes=6, dtype=dtype, generator=generator)
    seed_bn_statistics(model, generator)
    model = model.to(device, memory_format=torch.channels_last).eval()
    inferencer = SegInferencer(model, 6, tile=tile, stride=stride, fold_bn=fold_bn)
    batch = np.random.default_rng(0).normal(size=(images, size, size, 3)).astype(np.float32)
    return inferencer, batch


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


def stage2_state(device='cuda', *, resnet: str = 'ResNet101', seed: int = 0,
                 remat: bool = False, ins_norm: bool = True, group=None):
    """A stage-2 train state from seeded random weights, with seeded normal
    prototypes standing in for a prototype checkpoint, and the stage-2 step
    (align_domain, refine_label and sam_refine on); `remat` checkpoints
    every residual block of the encoder; `ins_norm` is the segmenter's
    instance norm (the recipe's default); `group` (a parallel.DataGroup)
    makes the step one rank's part of a data-parallel step."""
    device = _device(device)
    model = build_deeplabv2(resnet, num_classes=6, remat=remat, is_ins_norm=ins_norm,
                            generator=torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    protos = np.random.default_rng(seed).normal(
        size=(6, model.encoder.resnet.out_channels)).astype(np.float32)
    state = create_train_state(
        model, make_optimizer(model, 1e-2, stop_steps=6000),
        torch.Generator(device=device).manual_seed(seed), torch.from_numpy(protos))
    step = make_stage2_step(num_classes=6, align_domain=True,
                            refine_label=True, sam_refine=True, group=group)
    return state, step


def stage2_steps(n: int, device='cuda', *, remat: bool = False,
                 after_step: Optional[Callable] = None, group=None):
    """Run `n` f32 stage-2 steps of ResNet-101 (see `stage2_state`) at the
    recipe's shape, 8 crops of 512^2 per domain (configs/st/regda/
    _experiment.py:35), on seeded synthetic batches. Returns (state, metrics
    per step, seconds per step); each step's time ends in a synchronize,
    after which `after_step(i, state)` is called, outside the time. With
    `group`, each rank runs its rows of the same global batches."""
    device = _device(device)
    state, step = stage2_state(device, remat=remat, group=group)
    rng = np.random.default_rng(1)
    metrics, seconds = [], []
    for _ in range(n):
        batch_np = shard_batch(group, *synthetic_stage2_batch(rng, 8, 512))
        images_s, label_s, images_t, regs_t = (torch.from_numpy(a).to(device)
                                               for a in batch_np)
        t0 = time.perf_counter()
        metrics.append(step(state, images_s, label_s, images_t, regs_t))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(len(seconds) - 1, state)
    return state, metrics, seconds


def synthetic_soft_labels(rng: np.random.Generator, batch: int, size: int,
                          num_classes: int = 6, scale: float = 4.0) -> np.ndarray:
    """Stand-in for a batch of offline pseudo-label probabilities: the
    softmax over classes of seeded normal logits times `scale`, float32
    (batch, size, size, num_classes); at 4.0 about half the pixels are
    confident enough for the UVEM threshold."""
    logits = scale * rng.standard_normal((batch, size, size, num_classes), np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def stage3_state(device='cuda', *, resnet: str = 'ResNet101', seed: int = 0,
                 remat: bool = False, **step_kwargs):
    """A stage-3 train state as `stage2_state` builds one, and the stage-3
    step (refine_label and sam_refine on, lt='uvem'; `step_kwargs`
    override, `group` among them)."""
    state, _ = stage2_state(device, resnet=resnet, seed=seed, remat=remat)
    kwargs = dict(num_classes=6, refine_label=True, sam_refine=True, lt='uvem')
    kwargs.update(step_kwargs)
    return state, make_stage3_step(**kwargs)


def stage3_steps(n: int, device='cuda', *, remat: bool = False,
                 after_step: Optional[Callable] = None, group=None):
    """Run `n` f32 stage-3 steps of ResNet-101 (see `stage3_state`) at the
    recipe's shape, 8 crops of 512^2 per domain, on seeded synthetic
    batches: `synthetic_stage2_batch`'s images, labels and region maps (ids
    0..MAX_REGION_ID) and `synthetic_soft_labels`. Returns (state, metrics
    per step, seconds per step); each step's time ends in a synchronize,
    after which `after_step(i, state)` is called, outside the time. With
    `group`, each rank runs its rows of the same global batches."""
    device = _device(device)
    state, step = stage3_state(device, remat=remat, group=group)
    rng = np.random.default_rng(1)
    metrics, seconds = [], []
    for _ in range(n):
        images_s, label_s, images_t, regs_t = synthetic_stage2_batch(rng, 8, 512)
        soft = synthetic_soft_labels(rng, 8, 512)
        batch = [torch.from_numpy(a).to(device) for a in shard_batch(
            group, images_s, label_s, images_t, soft, regs_t)]
        t0 = time.perf_counter()
        metrics.append(step(state, *batch))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(len(seconds) - 1, state)
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


# the JAX dry run's own tolerances (tests/sharded_stages_child.py): on the
# card cuDNN sums a rank's rows in another order than the whole batch's
DRYRUN_RTOL, DRYRUN_PROTO_ATOL = 1e-4, 1e-5
# rows a domain a rank. With instance norm the PPM's pooled scale-1 BN
# normalizes rounding noise, and on the card (two rows a rank) another order
# of reduction moved the losses by up to 3e-4, past DRYRUN_RTOL; the dry run
# builds the segmenter without instance norm and, for a margin, gives that
# BN four values a channel on each rank
DRYRUN_ROWS = 4


def _dryrun_rank(rank: int, n: int, device: str, init_method: str,
                 backend: Optional[str]) -> None:
    """One rank of `dryrun_data_parallel`: the data-parallel stage-2 step on
    its rows; rank 0 also runs the one-process step on the whole batch and
    holds the two to each other."""
    from regda_tpu_torch import parallel
    from regda_tpu_torch.utils.tools import disable_tf32
    torch.set_num_threads(max(1, min(2, torch.get_num_threads())))
    disable_tf32()      # a spawned process starts with TF32 on
    group = parallel.data_group(rank, n, device, init_method=init_method, backend=backend)
    try:
        size, batch = 32, DRYRUN_ROWS * n
        batch_np = synthetic_stage2_batch(np.random.default_rng(1), batch, size)

        def run(group):
            state, step = stage2_state(group.device if group else device, resnet='resnet18',
                                       ins_norm=False, group=group)
            own = parallel.shard_batch(group, *batch_np)
            dev = state.prototypes.device
            metrics = step(state, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                    for a in own))
            return state, {k: float(v) for k, v in metrics.items()}

        state, metrics = run(group)
        parallel.assert_replicated(dict(state.model.state_dict(), prototypes=state.prototypes,
                                        class_freq_s=state.class_freq_s.freq), group)
        if rank == 0:
            ref, want = run(None)
            for k, v in want.items():
                if not np.isclose(metrics[k], v, rtol=DRYRUN_RTOL, atol=0.0):
                    raise AssertionError(f'dryrun_data_parallel({n}): {k} {metrics[k]} '
                                         f'against the one-process step\'s {v}')
            if not torch.allclose(state.prototypes, ref.prototypes, rtol=DRYRUN_RTOL,
                                  atol=DRYRUN_PROTO_ATOL):
                raise AssertionError(f'dryrun_data_parallel({n}): prototypes differ')
            print(f'dryrun_data_parallel({n}): {group.size} ranks on {group.device} '
                  f'loss={metrics["total"]:.4f} (one process {want["total"]:.4f}) OK',
                  flush=True)
    finally:
        parallel.shutdown()


def dryrun_data_parallel(n: int, device='cuda', *, backend: Optional[str] = None) -> None:
    """Start `n` ranks (one process each; `backend` defaults to nccl on the
    card, gloo on the CPU) that run one stage-2 step (LRH, CORAL, the
    prototype contrastive loss, SGD) of DeepLabv2 / resnet18 without
    instance norm at 32 px, four rows a domain a rank, and check it: losses
    and prototypes equal to the one-process step on the whole batch (rtol
    1e-4, prototypes atol 1e-5, as the JAX dry run holds its mesh), the
    parameters, BN statistics, prototypes and class balance bit-identical
    on every rank. Raises if a rank fails. On 'cuda', rank r runs on
    cuda:{r} unless the backend is gloo, which lets every rank share
    cuda:0 (`chip_smoke.py` phase 3b runs it so on one card)."""
    import torch.multiprocessing as mp
    if torch.device(device).type == 'cuda':
        _device(device)
        if backend == 'gloo':
            device = 'cuda:0'
    tmp = tempfile.mkdtemp(prefix='regda_dryrun_')
    try:
        init = 'file://' + os.path.join(tmp, 'rendezvous')
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n, device, init, backend))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f'dryrun_data_parallel({n}): ranks {failed} failed')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
