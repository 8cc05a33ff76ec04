"""Segmentation inference engine: whole tiles, sliding window, dihedral TTA
and multi-scale (counterpart of regda_tpu/infer.py:SegInferencer).

The one inference path of evaluation, single-image prediction
(`python -m regda_tpu_torch.tools.infer_single`) and offline pseudo-label
generation (regda/gast/pseudo_generation.py:96-155). The deployed forward is
the BN-folded model (models/fold_bn.py) with both PPM heads' shared conv
fused (models/fused_eval.py).

The numpy methods keep the JAX package's contract, (B, H, W, 3) float32
normalized images in and numpy out; `probs_tensor` and `multiscale_tensor`
under them take and return tensors on the model's device. (The JAX
inferencer's `compute_dtype`, which no caller sets, is the model's `dtype`
here.)

`group` (a parallel.DataGroup) is the counterpart of the JAX inferencer's
`mesh=`: each rank predicts its share of a batch (`parallel.share`; a short
share padded with copies of the last image) and the rows are gathered, so
that every rank returns the one-process result. The Trainer's evaluation
and offline pseudo-labelling run through it.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import numpy as np
import torch

from regda_tpu_torch.models.deeplabv2 import DeeplabV2
from regda_tpu_torch.models.fold_bn import fold_batchnorm, folded_model
from regda_tpu_torch.models.fused_eval import eval_forward
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners
from regda_tpu_torch.ops.slide import slide_inference
from regda_tpu_torch.ops.tta import tta_apply
from regda_tpu_torch.parallel.mesh import DataGroup, all_gather_rows, share

# the most input pixels one model call takes (64 tiles of 512^2): a larger
# batch of tiles or TTA variants runs as equal chunks below it, which bounds
# the activations' memory whatever the scene size
MAX_BATCH_PIXELS = 64 * 512 * 512

MULTISCALE_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


class SegInferencer:
    def __init__(self, model: DeeplabV2, num_classes: int, tile: int = 512,
                 stride: int = 256, fold_bn: Optional[bool] = None,
                 group: Optional[DataGroup] = None):
        """Serves `model` (a DeeplabV2 carrying its weights) on its device,
        computing in the model's `dtype`.

        fold_bn: fold every BatchNorm's eval affine into the conv before it
        (models/fold_bn.py); the default is on for an unfolded model unless
        REGDA_NO_FOLD_BN=1. The fused dual-PPM forward (models/fused_eval.py)
        is taken where the served model supports it, unless REGDA_NO_FUSED_PPM
        is set. Both variables are read here, once."""
        if fold_bn is None:
            fold_bn = os.environ.get('REGDA_NO_FOLD_BN') != '1' and not model.folded
        self.fold_bn = fold_bn
        self.fused_ppm = not os.environ.get('REGDA_NO_FUSED_PPM')
        self.model = (folded_model(model) if fold_bn else model).eval()
        self.device = next(self.model.parameters()).device
        self.num_classes = num_classes
        self.tile = tile
        self.stride = stride
        self.group = group

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load new (unfolded) weights, e.g. after a training interval;
        they are folded first where this inferencer folds."""
        if self.fold_bn:
            state_dict = fold_batchnorm(state_dict)
        self.model.load_state_dict(state_dict)

    def _apply_probs(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        chunks = math.ceil(n * x.shape[1] * x.shape[2] / MAX_BATCH_PIXELS)
        size = math.ceil(n / chunks)
        return torch.cat([eval_forward(self.model, x[i:i + size], self.fused_ppm).float()
                          for i in range(0, n, size)])

    def _sharded(self, fn, images: torch.Tensor) -> torch.Tensor:
        """fn over this rank's rows of `images`, every rank's rows gathered
        (fn(images) without a group)."""
        group = self.group
        if group is None:
            return fn(images)
        n = images.shape[0]
        own, per = images[share(group, n)], -(-n // group.size)
        if own.shape[0] < per:       # a short share pads: gathered rows are equal
            own = torch.cat([own, images[-1:].expand(per - own.shape[0], *images.shape[1:])])
        return all_gather_rows(fn(own), group)[:n]

    @torch.inference_mode()
    def probs_tensor(self, images: torch.Tensor, slide: bool = True,
                     tta: bool = False) -> torch.Tensor:
        """(B, H, W, 3) float32 on the model's device -> (B, H, W, C) float32."""
        return self._sharded(lambda x: self._probs(x, slide, tta), images)

    def _probs(self, images: torch.Tensor, slide: bool, tta: bool) -> torch.Tensor:
        if slide:
            return slide_inference(self._apply_probs, images, self.num_classes,
                                   self.tile, self.stride, tta)
        if tta:
            return tta_apply(self._apply_probs, images)
        return self._apply_probs(images)

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)

    def predict_probs(self, images: np.ndarray, slide: bool = True,
                      tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W, C) probs."""
        return self.probs_tensor(self._to_device(images), slide, tta).cpu().numpy()

    @torch.inference_mode()
    def predict_labels(self, images: np.ndarray, slide: bool = True,
                       tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W) int32 class
        map, argmaxed on the device (only H * W bytes come back)."""
        labels = self._sharded(
            lambda x: self._probs(x, slide, tta).argmax(-1).to(torch.uint8),
            self._to_device(images))
        return labels.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def multiscale_tensor(self, images: torch.Tensor, scales=MULTISCALE_SCALES,
                          tta: bool = False) -> torch.Tensor:
        """Whole-image inference at each scale (align-corners resize there
        and back), averaged: (B, H, W, 3) -> (B, H, W, C) float32 (reference
        regda/utils/tools.py:99-128). Each scale is one call of the model's
        own forward, as in the JAX package."""
        return self._sharded(lambda x: self._multiscale(x, scales, tta), images)

    def _multiscale(self, images: torch.Tensor, scales, tta: bool) -> torch.Tensor:
        h, w = images.shape[1:3]
        total = None
        for scale in scales:
            scaled = resize_bilinear_align_corners(
                images, (int(round(h * scale)), int(round(w * scale))))
            probs = tta_apply(self.model, scaled) if tta else self.model(scaled)
            p = resize_bilinear_align_corners(probs.float(), (h, w))
            total = p if total is None else total + p
        return total / len(scales)

    def predict_multiscale(self, images: np.ndarray, scales=MULTISCALE_SCALES,
                           tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W, C) mean probs."""
        return self.multiscale_tensor(self._to_device(images), scales, tta).cpu().numpy()
