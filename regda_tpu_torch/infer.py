"""Segmentation inference engine: whole tiles, sliding window, dihedral TTA
and multi-scale (counterpart of regda_tpu/infer.py:SegInferencer).

The one inference path of evaluation, single-image prediction
(`python -m regda_tpu_torch.tools.infer_single`) and offline pseudo-label
generation (regda/gast/pseudo_generation.py:96-155). The deployed forward is
the BN-folded model (models/fold_bn.py) with both PPM heads' shared conv
fused (models/fused_eval.py).

The engines of the 3x3 stride-1 convolutions are chosen by measurement,
not by cuDNN's heuristics, which send some of them in float32 to a slower
FFT engine: the first forward of each input signature an inferencer meets
(span `infer.tune`) runs each such convolution with
`torch.backends.cudnn.benchmark` on, so cuDNN times its candidates and
caches the fastest plan, which later forwards of the signature reuse with
the flag as the caller set it. The other convolutions keep their
heuristic engines, which measured as fast as the timed ones, and skip the
set-up their timing would cost. `tuned` counts the signatures.

The numpy methods keep the JAX package's contract, (B, H, W, 3) float32
normalized images in and numpy out (the images may also be a float32
tensor on the model's device, as a DeviceEvalSet gives them);
`probs_tensor` and `multiscale_tensor` under them take and return tensors
on the model's device. (The JAX
inferencer's `compute_dtype`, which no caller sets, is the model's `dtype`
here.)

`group` (a parallel.DataGroup) is the counterpart of the JAX inferencer's
`mesh=`: each rank predicts its share of a batch (`parallel.share`; a short
share padded with copies of the last image) and the rows are gathered, so
that every rank returns the one-process result. The Trainer's evaluation
and offline pseudo-labelling run through it.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from regda_tpu_torch.datasets.device_data import batch_tensor
from regda_tpu_torch.models.deeplabv2 import DeeplabV2
from regda_tpu_torch.models.fold_bn import fold_batchnorm, folded_model
from regda_tpu_torch.models.fused_eval import eval_forward
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners
from regda_tpu_torch.ops.slide import slide_inference
from regda_tpu_torch.ops.tta import tta_apply
from regda_tpu_torch.parallel.mesh import DataGroup, all_gather_rows, share
from regda_tpu_torch.utils.profiling import span

# the most input pixels one model call takes (64 tiles of 512^2): a larger
# batch of tiles or TTA variants runs as equal chunks below it, which bounds
# the activations' memory whatever the scene size
MAX_BATCH_PIXELS = 64 * 512 * 512

MULTISCALE_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


# a forward's convolutions as the port calls them, each with the place of
# its `stride` argument
_CONVOLUTIONS = {torch.nn.functional.conv2d: 3, torch.cudnn_convolution_relu: 3,
                 torch.cudnn_convolution_add_relu: 5}


def _is_3x3_stride_1(func, args, kwargs) -> bool:
    at = _CONVOLUTIONS[func]
    stride = args[at] if len(args) > at else kwargs.get('stride', 1)
    return (tuple(args[1].shape[-2:]) == (3, 3)
            and all(s == 1 for s in ((stride,) if isinstance(stride, int) else stride)))


class _MeasuredEngines(TorchFunctionMode):
    """Inside, cuDNN chooses the engine of each 3x3 stride-1 convolution by
    timing its candidates, and caches the fastest plan: `benchmark` is on
    around that call alone and restored after it. Only that flag is set:
    `torch.backends.cudnn.flags` would also set every other cuDNN flag to its
    own defaults (cuDNN off, TF32 on). (A function mode, not a dispatch mode:
    the first op under a dispatch mode imports sympy and much of torch's
    compiler, seconds of set-up.)"""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _CONVOLUTIONS or not _is_3x3_stride_1(func, args, kwargs):
            return func(*args, **kwargs)
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return func(*args, **kwargs)
        finally:
            torch.backends.cudnn.benchmark = saved


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
        self._signatures = set()

    @property
    def tuned(self) -> int:
        """The input signatures whose forward chose cuDNN's engines by
        measurement."""
        return len(self._signatures)

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load new (unfolded) weights, e.g. after a training interval;
        they are folded first where this inferencer folds."""
        if self.fold_bn:
            state_dict = fold_batchnorm(state_dict)
        self.model.load_state_dict(state_dict)

    def _forward(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(x), a forward of the model; under measured engines the first
        time this inferencer meets x's shape, dtype and layout (strides)."""
        signature = (tuple(x.shape), x.dtype, x.stride())
        if signature in self._signatures:
            return fn(x)
        with span('infer.tune'), _MeasuredEngines():
            out = fn(x)
        self._signatures.add(signature)
        return out

    def _apply_probs(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        chunks = math.ceil(n * x.shape[1] * x.shape[2] / MAX_BATCH_PIXELS)
        size = math.ceil(n / chunks)
        forward = functools.partial(eval_forward, self.model, fused=self.fused_ppm)
        return torch.cat([self._forward(forward, x[i:i + size]).float()
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

    def _probs(self, images: torch.Tensor, slide: bool, tta: bool,
               labels: bool = False) -> torch.Tensor:
        """Probabilities, or with `labels` their argmax as uint8."""
        with span('infer.forward'):
            if slide:
                probs = slide_inference(self._apply_probs, images, self.num_classes,
                                        self.tile, self.stride, tta)
            elif tta:
                probs = tta_apply(self._apply_probs, images)
            else:
                probs = self._apply_probs(images)
            return probs.argmax(-1).to(torch.uint8) if labels else probs

    def _to_device(self, images) -> torch.Tensor:
        """Numpy images uploaded as float32; a float32 tensor on this
        device (a DeviceEvalSet's batch) taken as it is; any other tensor
        refused."""
        with span('infer.upload'):
            return batch_tensor(images, self.device, torch.float32)

    def predict_probs(self, images: np.ndarray, slide: bool = True,
                      tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W, C) probs."""
        with span('infer.predict'):
            probs = self.probs_tensor(self._to_device(images), slide, tta)
            with span('infer.download'):
                return probs.cpu().numpy()

    @torch.inference_mode()
    def predict_labels(self, images: np.ndarray, slide: bool = True,
                       tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W) int32 class
        map, argmaxed on the device (only H * W bytes come back)."""
        with span('infer.predict'):
            labels = self._sharded(lambda x: self._probs(x, slide, tta, labels=True),
                                   self._to_device(images))
            with span('infer.download'):
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
        forward = functools.partial(self._forward, self.model)
        with span('infer.forward'):
            for scale in scales:
                scaled = resize_bilinear_align_corners(
                    images, (int(round(h * scale)), int(round(w * scale))))
                probs = tta_apply(forward, scaled) if tta else forward(scaled)
                p = resize_bilinear_align_corners(probs.float(), (h, w))
                total = p if total is None else total + p
            return total / len(scales)

    def predict_multiscale(self, images: np.ndarray, scales=MULTISCALE_SCALES,
                           tta: bool = False) -> np.ndarray:
        """images: (B, H, W, 3) normalized float32 -> (B, H, W, C) mean probs."""
        with span('infer.predict'):
            probs = self.multiscale_tensor(self._to_device(images), scales, tta)
            with span('infer.download'):
                return probs.cpu().numpy()
