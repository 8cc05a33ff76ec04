"""How far SAM's fast stability score departs from the exact one (the port's
counterpart of tools/check_sam_stability.py).

The fast score counts the 256x256 low-res logits; upstream segment-anything
(driven at regda/utils/local_region_homog.py:32-39) scores the logits
resized to crop resolution, which the port's generators do by default
(`stability_on_upscaled=True`). This tool measures:

  1. per-candidate stability deltas and decision flips at the threshold
     (0.95) and at the median score, both scores from the SAME decoded
     logits of the same chunks, of every candidate: the IoU gate is off
     here (the JAX tool measures the same with REGDA_SAM_NO_IOU_GATE=1;
     with the gate on it scores gated candidates from counts its kernel
     never wrote);
  2. how the region maps of the two modes differ (region counts,
     assigned-pixel agreement, pairwise same-region agreement) at
     crop_n_layers 0 and 1.

Without --checkpoint the model runs with seeded random weights, so the
numbers describe the mechanism, not SAM's trained masks. --checkpoint
takes a segment-anything `.pth` (`models/sam/convert.py:load_sam_state_dict`).
The report is printed as JSON and written to --out when given. The run is
on the card unless `--device cpu` asks otherwise.

  python -m regda_tpu_torch.tools.check_sam_stability [--vit-config vit_b]
      [--tiles 4] [--size 512] [--checkpoint sam.pth] [--auto-thresh]
      [--out report.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from regda_tpu_torch.entry import _device, _seeded_sam
from regda_tpu_torch.models.sam.auto import (Sam, SamRegionGenerator, build_point_grid,
                                             preprocess_shape)
from regda_tpu_torch.models.sam.convert import load_sam_state_dict


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description='SAM fast vs exact stability scores.')
    ap.add_argument('--vit-config', default='vit_b')
    ap.add_argument('--img-size', type=int, default=1024)
    ap.add_argument('--tiles', type=int, default=4)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--points-per-side', type=int, default=32)
    ap.add_argument('--points-per-batch', type=int, default=128)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    # with random weights the reference thresholds pass no candidate and
    # the region comparison is vacuous; relax them so that the two modes'
    # selections can differ where their scores do
    ap.add_argument('--iou-thresh', type=float, default=0.90)
    ap.add_argument('--stability-thresh', type=float, default=0.95)
    ap.add_argument('--area-threshold', type=int, default=1024)
    ap.add_argument('--auto-thresh', action='store_true',
                    help='after measuring the score distributions, set the region '
                         'thresholds at the pooled medians, so that about half the '
                         'candidates pass')
    ap.add_argument('--device', default='cuda')
    return ap


def load_model(args, device: torch.device) -> Sam:
    if not args.checkpoint:
        return _seeded_sam(device, args.vit_config, args.img_size, torch.bfloat16, args.seed)
    model = Sam(vit_config=args.vit_config, img_size=args.img_size)
    load_sam_state_dict(model, torch.load(args.checkpoint, map_location='cpu',
                                          weights_only=True))
    return model.to(device).eval()


def _pct(a: np.ndarray) -> dict:
    return {f'p{q}': float(np.percentile(a, q)) for q in (5, 25, 50, 75, 95)}


def stability_deltas(gen_fast, gen_exact, tiles, points_per_side: int,
                     points_per_batch: int):
    """Both scores and the IoU of every candidate of every tile's whole
    grid (crop 0), from the same decoded logits: -> (fast, exact, iou), flat
    float arrays."""
    h, w = tiles[0].shape[:2]
    nh, nw = preprocess_shape(h, w, gen_fast.img_size)
    pts = (build_point_grid(points_per_side) * np.array([nw, nh], np.float32)).astype(np.float32)
    n_pts, pb = len(pts), points_per_batch
    pts = np.concatenate([pts, np.zeros(((-n_pts) % pb, 2), np.float32)])
    pts = torch.from_numpy(pts).to(gen_fast.device)
    all_f, all_e, all_iou = [], [], []
    for tile in tiles:
        crop = torch.from_numpy(np.ascontiguousarray(tile)).to(gen_fast.device)
        emb = gen_fast._encode(gen_fast._preprocess_device(crop))
        for lo in range(0, n_pts, pb):
            keep = 3 * (min(lo + pb, n_pts) - lo)      # 3 masks a point
            chunk = pts[lo:lo + pb]
            _, iou_f, st_f = gen_fast._decode_chunk(emb, chunk)
            _, _, st_e = gen_exact._decode_chunk(emb, chunk, (nh, nw, h, w))
            all_f.append(st_f.float().cpu().numpy().ravel()[:keep])
            all_e.append(st_e.float().cpu().numpy().ravel()[:keep])
            all_iou.append(iou_f.float().cpu().numpy().ravel()[:keep])
    return np.concatenate(all_f), np.concatenate(all_e), np.concatenate(all_iou)


@torch.inference_mode()
def main(argv=None) -> dict:
    """-> the report (also printed, and written to --out when given)."""
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    model = load_model(args, device)
    kwargs = dict(points_per_side=args.points_per_side,
                  points_per_batch=args.points_per_batch,
                  pred_iou_thresh=args.iou_thresh,
                  stability_score_thresh=args.stability_thresh,
                  crop_n_points_downscale_factor=2)
    rng = np.random.RandomState(args.seed)
    tiles = [rng.randint(0, 255, (args.size, args.size, 3), np.uint8).astype(np.uint8)
             for _ in range(args.tiles)]
    report = {}

    # 1. per-candidate stability deltas from the same logits; the IoU gate
    # is off, since a gated candidate's mask and exact counts are never
    # computed and its scores would measure nothing
    gen_fast, gen_exact = (SamRegionGenerator(model, crop_n_layers=0, stability_on_upscaled=exact,
                                              iou_gate=False, **kwargs)
                           for exact in (False, True))
    st_f, st_e, iou_f = stability_deltas(gen_fast, gen_exact, tiles, args.points_per_side,
                                         args.points_per_batch)
    deltas = st_f - st_e
    n_cand = int(st_f.size)
    thr = args.stability_thresh
    flips = int(((st_f >= thr) != (st_e >= thr)).sum())
    med = float(np.median(st_f))
    flips_med = int(((st_f >= med) != (st_e >= med)).sum())
    report['stability_delta'] = {
        'n_candidates': n_cand,
        'mean_abs': float(np.abs(deltas).mean()),
        'p95_abs': float(np.percentile(np.abs(deltas), 95)),
        'max_abs': float(np.abs(deltas).max()),
        f'decision_flips_at_{thr}': flips,
        'flip_rate': float(flips / max(n_cand, 1)),
        'decision_flips_at_median': flips_med,
        'flip_rate_at_median': float(flips_med / max(n_cand, 1)),
        'score_dist_fast': _pct(st_f),
        'score_dist_exact': _pct(st_e),
        'iou_dist': _pct(iou_f),
    }
    if args.auto_thresh:
        kwargs['stability_score_thresh'] = med
        kwargs['pred_iou_thresh'] = float(np.median(iou_f))
        report['auto_thresholds'] = {'iou': kwargs['pred_iou_thresh'], 'stability': med}

    # 2. region-map divergence, crop layers 0 and 1
    for layers in (0, 1):
        maps = [SamRegionGenerator(model, crop_n_layers=layers, stability_on_upscaled=exact,
                                   **kwargs).generate_regions_batch(
                    tiles, area_threshold=args.area_threshold)
                for exact in (False, True)]
        assigned, pairs = [], []
        prng = np.random.RandomState(1)
        for a, b in zip(*maps):
            assigned.append(float(((a > 0) == (b > 0)).mean()))
            idx = prng.randint(0, a.size, size=(2000, 2))
            fa, fb = a.ravel(), b.ravel()
            pairs.append(float(((fa[idx[:, 0]] == fa[idx[:, 1]])
                                == (fb[idx[:, 0]] == fb[idx[:, 1]])).mean()))
        report[f'regions_crop{layers}'] = {
            'region_counts_fast': [int(len(np.unique(r)) - 1) for r in maps[0]],
            'region_counts_exact': [int(len(np.unique(r)) - 1) for r in maps[1]],
            'assigned_pixel_agreement': float(np.mean(assigned)),
            'pairwise_same_region_agreement': float(np.mean(pairs)),
        }

    report['config'] = {'vit_config': args.vit_config, 'tiles': args.tiles,
                        'size': args.size, 'seed': args.seed,
                        'checkpoint': args.checkpoint or 'random-init',
                        'device': (torch.cuda.get_device_name(device) if device.type == 'cuda'
                                   else device.type)}
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == '__main__':
    main()
