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
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from regda_tpu_torch.entry import _device, _seeded_sam
from regda_tpu_torch.models.sam.auto import (Sam, SamAutomaticMaskGenerator,
                                             SamRegionGenerator, regions_from_anns)
from regda_tpu_torch.models.sam.convert import load_sam_state_dict


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
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def load_model(args) -> Sam:
    device = _device(args.device)
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
    args = build_parser().parse_args(argv)
    gen_cls = SamRegionGenerator if args.fast else SamAutomaticMaskGenerator
    gen = gen_cls(load_model(args),
                  points_per_side=args.points_per_side,
                  pred_iou_thresh=args.pred_iou_thresh,
                  stability_score_thresh=args.stability_thresh,
                  crop_n_layers=args.crop_n_layers,
                  crop_n_points_downscale_factor=2)

    for img_dir in args.img_dirs:
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
            for fname, regions in zip(chunk, region_maps):
                Image.fromarray(regions.astype(np.int32), mode='I').save(
                    os.path.join(out_dir, fname.replace('.png', '.tif')))
            done += len(chunk)
            print(f'{img_dir}: {done}/{len(files)} tiles '
                  f'({done / (time.time() - t0):.2f} tiles/s)')
        print(f'{img_dir}: done ({len(files)} tiles)')


if __name__ == '__main__':
    main()
