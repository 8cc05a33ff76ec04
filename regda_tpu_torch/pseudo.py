"""Offline pseudo-label generation over the target set (counterpart of
regda_tpu/pseudo.py).

Parity target: regda/gast/pseudo_generation.py:96-155 (`gener_target_pseudo`
with save_prob=True as train_ssl_reg.py:188 calls it): for each batch of
target tiles, slide (+ TTA) inference, a bilinear align-corners resize to
`size`, one float32 (H, W, C) probability map per tile saved as
`<fname>.npy` (the JAX package's layout, read back by the 'prob' label type
of datasets/basedata.py), and a palette PNG of the selected hard labels
under `<dir>_color`. With save_prob=False, the hard labels + 1 go to uint8
PNGs instead. The probabilities stay on the inferencer's device until the
resize and the selection are done; each batch comes back to the host once.
With an inferencer that has a `group` (a data-parallel Trainer's), each rank
predicts its share of every batch and the probabilities are gathered; the
first rank writes every file, and the call returns on every rank once it
has.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from regda_tpu_torch.datasets import get_meta
from regda_tpu_torch.ops.pseudo import pseudo_selection
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners
from regda_tpu_torch.parallel.mesh import barrier, is_primary
from regda_tpu_torch.utils.viz import VisualizeSegmm


@torch.inference_mode()
def gener_target_pseudo(cfg, inferencer, pseudo_loader, save_pseudo_label_path,
                        slide: bool = True, save_prob: bool = True,
                        size=None, ignore_label: int = -1, tta: bool = True,
                        logger=None):
    meta = get_meta(cfg.DATASETS)
    group = inferencer.group
    size = tuple(size or meta.size)
    os.makedirs(save_pseudo_label_path, exist_ok=True)
    color_path = save_pseudo_label_path + '_color'
    os.makedirs(color_path, exist_ok=True)
    viz_op = VisualizeSegmm(color_path, meta.palette)
    select = getattr(cfg, 'PSEUDO_SELECT', True)

    for i, batch in enumerate(pseudo_loader):
        images = torch.from_numpy(np.ascontiguousarray(batch['image'], np.float32))
        probs = inferencer.probs_tensor(images.to(inferencer.device), slide=slide, tta=tta)
        if tuple(probs.shape[1:3]) != size:
            probs = resize_bilinear_align_corners(probs, size)
        if not is_primary(group):
            continue
        if save_prob:
            hard = (pseudo_selection(probs, cfg.CUTOFF_TOP, cfg.CUTOFF_LOW, ignore_label)
                    if cfg.SNAPSHOT_DIR is not None else None)
            probs = probs.cpu().numpy()
            for fname, p in zip(batch['fname'], probs):
                np.save(os.path.join(save_pseudo_label_path, fname + '.npy'),
                        p.astype(np.float32))
            if hard is not None:
                for fname, pred in zip(batch['fname'], hard.cpu().numpy()):
                    viz_op(pred, fname.replace('.tif', '.png')
                           if fname.endswith('.tif') else fname)
        else:
            hard = (pseudo_selection(probs, ignore_label=ignore_label) if select
                    else probs.argmax(-1)).cpu().numpy()
            from PIL import Image
            for fname, pred in zip(batch['fname'], hard):
                Image.fromarray((pred + 1).astype(np.uint8)).save(
                    os.path.join(save_pseudo_label_path, fname))
                if cfg.SNAPSHOT_DIR is not None:
                    viz_op(pred, fname.replace('.tif', '.png'))
        if logger is not None and (i + 1) % 100 == 0:
            logger.info(f'pseudo generation: {i + 1} tiles done')
    barrier(group)
