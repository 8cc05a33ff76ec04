"""Generate SAM everything-mode local-region maps for target-domain tiles.

The port's counterpart of tools/seg_everything.py: sweeps the image
directories, writes int32 region maps (region id = kept-mask index + 1, area
>= 1024 px, 0 = unassigned) to the sibling `reg_dir` as .tif, the files that
stage 2's LRH reads.

  python -m regda_tpu_torch.tools.seg_everything \
      --img-dirs data/IsprsDA/Vaihingen/img_dir/train \
      [--checkpoint ckpts/sam_vit_b_01ec64.pth] [--model-type vit_b] [--device cuda]

`--checkpoint` is a segment-anything .pth: its state_dict names are the
port's own. Every parameter must be in it under its name, or the load raises
KeyError; only the mask-prompt branch (`prompt_encoder.mask_downscaling.*`,
which the port has no place for) and `pixel_mean` / `pixel_std` may be extra
or absent. Without it the model runs with seeded random weights (the
official checkpoint is not in the repository), and the region maps are not
SAM's. The run is on the card unless `--device cpu` asks otherwise.

`--data-mesh N` (with `--fast 1`, as the JAX CLI asserts) passes an N-rank
process group to the generator, as the JAX CLI passes its mesh: every batch
of tiles is split over the ranks (`SamRegionGenerator(group=)`), rank r
encodes and decodes its share of the batch and writes those tiles' maps, on
`cuda:{LOCAL_RANK % cards}` under torchrun and `cuda:{r % cards}`
otherwise. The group is `gloo`: the ranks exchange only the finished maps,
as host objects, so several ranks may share a card, which NCCL refuses.
Started by `torchrun --nproc_per_node N`, the ranks are torchrun's
processes; otherwise the command starts N processes itself. A tile's map
does not depend on the other tiles of its batch, so the maps equal the
one-process run's.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from argparse import ArgumentParser

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from regda_tpu_torch.entry import _device, _seeded_sam
from regda_tpu_torch.models.sam.auto import (Sam, SamAutomaticMaskGenerator,
                                             SamRegionGenerator, regions_from_anns)
from regda_tpu_torch.models.sam.convert import load_sam_state_dict
from regda_tpu_torch.parallel.mesh import data_group, share, shutdown


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='SAM everything-mode region maps.')
    parser.add_argument('--img-dirs', type=str, nargs='+',
                        default=['data/IsprsDA/Vaihingen/img_dir/train',
                                 'data/IsprsDA/Potsdam/img_dir/train'])
    parser.add_argument('--checkpoint', type=str, default=None)
    parser.add_argument('--model-type', type=str, default='vit_b',
                        choices=['vit_b', 'vit_l', 'vit_h', 'vit_t'],
                        help='vit_t is a tiny random-weight config for smoke runs')
    parser.add_argument('--img-size', type=int, default=1024,
                        help='SAM input resolution (lower for smoke runs)')
    parser.add_argument('--area-threshold', type=int, default=1024)
    parser.add_argument('--points-per-side', type=int, default=32)
    parser.add_argument('--pred-iou-thresh', type=float, default=0.90)
    parser.add_argument('--stability-thresh', type=float, default=0.95)
    parser.add_argument('--crop-n-layers', type=int, default=1)
    parser.add_argument('--batch-tiles', type=int, default=8,
                        help='tiles per batch of queued device work (fast path)')
    parser.add_argument('--fast', type=int, default=1,
                        help='device-painted region maps (1, default) or the '
                             'mask-downloading parity path (0)')
    parser.add_argument('--data-mesh', type=int, default=0,
                        help='split the tiles over this many ranks, one process '
                             'each (0 = one process; requires --fast 1)')
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def _rank_device(device: str, local_rank: int) -> torch.device:
    """A rank's device: `cuda` means cuda:{local_rank % cards}."""
    device = _device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', local_rank % torch.cuda.device_count())
    return device


def load_model(args, device: torch.device | None = None) -> Sam:
    """SAM on `device` (default: `--device`, which must exist)."""
    device = _device(args.device) if device is None else device
    if not args.checkpoint:
        print('WARNING: no --checkpoint given; using random SAM weights '
              '(region maps will not match reference SAM regions)')
        return _seeded_sam(device, args.model_type, args.img_size, torch.bfloat16, 0)
    model = Sam(vit_config=args.model_type, img_size=args.img_size)
    state = torch.load(args.checkpoint, map_location='cpu', weights_only=True)
    load_sam_state_dict(model, state)   # a misnamed or missing key raises KeyError
    print(f'loaded SAM weights from {args.checkpoint}')
    return model.to(device).eval()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.data_mesh and not args.fast:
        raise SystemExit('--data-mesh requires --fast 1')
    size = max(args.data_mesh, 1)
    if 'WORLD_SIZE' in os.environ and size > 1:
        if int(os.environ['WORLD_SIZE']) != size:
            raise SystemExit(f"--data-mesh {size} under torchrun's world size "
                             f"{os.environ['WORLD_SIZE']}")
        run(args, int(os.environ['RANK']), size,
            int(os.environ.get('LOCAL_RANK', os.environ['RANK'])))
    elif size > 1:
        rendezvous = tempfile.mkdtemp(prefix='regda_seg_everything_')
        init = 'file://' + os.path.join(rendezvous, 'init')
        try:
            ctx = mp.get_context('spawn')
            procs = [ctx.Process(target=_rank_main, args=(argv, r, size, init))
                     for r in range(size)]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
        finally:
            shutil.rmtree(rendezvous, ignore_errors=True)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f'seg_everything ranks {failed} of {size} failed')
    else:
        run(args)


def _rank_main(argv, rank: int, size: int, init: str) -> None:
    run(build_parser().parse_args(argv), rank, size, init_method=init)


def run(args, rank: int = 0, size: int = 1, local_rank: int | None = None,
        init_method: str = 'env://') -> None:
    """Write the region maps of each directory as rank `rank` of `size`
    (one process: all of them), on the card of `local_rank` (default:
    `rank`)."""
    tag = f'[rank {rank}/{size}] ' if size > 1 else ''
    gen_cls = SamRegionGenerator if args.fast else SamAutomaticMaskGenerator
    device = _rank_device(args.device, rank if local_rank is None else local_rank)
    joined = size > 1 and not dist.is_initialized()     # else this process's own group
    group = (data_group(rank, size, device, init_method=init_method, backend='gloo')
             if size > 1 else None)
    try:
        gen = gen_cls(load_model(args, device),
                      points_per_side=args.points_per_side,
                      pred_iou_thresh=args.pred_iou_thresh,
                      stability_score_thresh=args.stability_thresh,
                      crop_n_layers=args.crop_n_layers,
                      crop_n_points_downscale_factor=2, group=group)
        for img_dir in args.img_dirs:
            _sweep(args, gen, img_dir, tag)
    finally:
        if joined:
            shutdown()


def _sweep(args, gen, img_dir: str, tag: str) -> None:
    files = sorted(f for f in os.listdir(img_dir) if f.endswith('.png'))
    out_dir = img_dir.replace('img_dir', 'reg_dir')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    bt = max(args.batch_tiles, 1) if args.fast else 1
    chunks = [files[lo:lo + bt] for lo in range(0, len(files), bt)]

    def _load(chunk):
        return [np.asarray(Image.open(os.path.join(img_dir, f)).convert('RGB'))
                for f in chunk]

    if args.fast:
        # pipelined: batch k + 1's device work is queued before batch k's
        # host tail (NMS, canvas download)
        maps_iter = gen.generate_regions_stream((_load(c) for c in chunks),
                                                args.area_threshold)
    else:
        maps_iter = ([regions_from_anns(gen.generate(image), image.shape[:2],
                                        args.area_threshold)
                      for image in _load(chunk)] for chunk in chunks)
    done = 0
    for chunk, region_maps in zip(chunks, maps_iter):
        own = share(gen.group, len(chunk))      # this rank writes the tiles it made
        for fname, regions in zip(chunk[own], region_maps[own]):
            Image.fromarray(regions.astype(np.int32), mode='I').save(
                os.path.join(out_dir, fname.replace('.png', '.tif')))
        done += len(chunk)
        print(f'{tag}{img_dir}: {done}/{len(files)} tiles '
              f'({done / (time.time() - t0):.2f} tiles/s)')
    print(f'{tag}{img_dir}: done ({len(files)} tiles)')


if __name__ == '__main__':
    main()
