"""Evaluation harness: slide inference over the val/test split + metric table
(counterpart of regda_tpu/utils/eval.py).

Parity target: regda/utils/eval.py:14-56 (`evaluate`): DALoader over
EVAL/TEST_DATA_CONFIG at batch 1 (a DeviceEvalSet where device data is on,
datasets/device_data.py), per-tile slide(+TTA) labels, mask gt>=0,
streaming PixelMetricIgnore (class 0 ignored for IsprsDA), palette-PNG dump
per tile, table summary -> (table, mIoU).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from regda_tpu_torch.datasets import eval_loader, get_meta
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.parallel.mesh import is_primary
from regda_tpu_torch.utils.checkpoint import load_state_dict
from regda_tpu_torch.utils.convert import load_segmenter_state_dict
from regda_tpu_torch.utils.metrics import PixelMetricIgnore
from regda_tpu_torch.utils.tools import count_model_parameters
from regda_tpu_torch.utils.viz import VisualizeSegmm


def evaluate(model, state_dict: Optional[Mapping[str, torch.Tensor]], cfg,
             is_training: bool = False, ckpt_path: str | None = None, logger=None,
             slide: bool = True, tta: bool = False, test: bool = False,
             inferencer: Optional[SegInferencer] = None, save_viz: bool = True):
    """Evaluate `model` (a DeeplabV2 on the device to run on) with the
    weights `state_dict`, or, outside training, those of `ckpt_path`.
    With `inferencer` (one built once over a model of the same layout), the
    weights go into it and `model` is not touched. An inferencer with a
    `group` (a data-parallel Trainer's) predicts each rank's share of every
    batch and gathers the labels, so every rank computes the whole
    evaluation's table and mIoU; only the first rank logs it and writes
    the visualisations."""
    primary = inferencer is None or is_primary(inferencer.group)
    if not primary:
        logger = None
    meta = get_meta(cfg.DATASETS)
    ignore_labels = [0] if cfg.DATASETS == 'IsprsDA' else []
    os.makedirs(cfg.SNAPSHOT_DIR, exist_ok=True)

    if not is_training and ckpt_path is not None:
        state_dict = load_state_dict(ckpt_path)
        if logger:
            logger.info('[Load params] from {}'.format(ckpt_path))
            count_model_parameters(state_dict, logger)

    viz_op = None
    if save_viz and primary and cfg.SNAPSHOT_DIR is not None and ckpt_path is not None:
        vis_dir = os.path.join(cfg.SNAPSHOT_DIR,
                               'vis-{}'.format(os.path.basename(ckpt_path)))
        viz_op = VisualizeSegmm(vis_dir, meta.palette)

    data_cfg = cfg.TEST_DATA_CONFIG if test else cfg.EVAL_DATA_CONFIG
    # with device data on, the split lives on the device as uint8 and is
    # normalised there, uploaded once a process rather than once an eval
    device = inferencer.device if inferencer is not None else next(model.parameters()).device
    loader = eval_loader(data_cfg, cfg.DATASETS, device, logger)

    if inferencer is None:
        if state_dict is not None:
            load_segmenter_state_dict(model, state_dict)
        inferencer = SegInferencer(model, meta.num_classes)
    elif state_dict is not None:
        inferencer.update_variables(state_dict)

    metric = PixelMetricIgnore(meta.num_classes, class_names=meta.class_names,
                               logdir=cfg.SNAPSHOT_DIR, logger=logger,
                               ignore_labels=ignore_labels)
    for batch in loader:
        cls = inferencer.predict_labels(batch['image'], slide=slide, tta=tta)
        gt = batch['cls'].astype(np.int32)
        mask = gt >= 0
        metric.forward(gt[mask].ravel(), cls[mask].ravel())
        if viz_op is not None:
            for fname, pred in zip(batch['fname'], cls):
                viz_op(pred, fname.replace('tif', 'png'))

    return metric.summary_all()
