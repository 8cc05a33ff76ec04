"""DeepLabv2 segmenter: dilated ResNet encoder + dual PPM heads.

Counterpart of regda_tpu/models/deeplabv2.py (reference: regda/models/
Encoder.py:87-186). The defaults, multi_layer=True, use_ppm=True,
is_ins_norm=True, are the configuration every RegDA tool builds; the other
settings give one head (`cls_pred`), ASPP heads, or no instance norm.
`folded=True` is the inference-only model whose BatchNorms were folded into
their convs (models/fold_bn.py). `output_stride` (8, 16 or 32) and `remat`
(per-block gradient checkpointing in training) go to the encoder
(models/resnet.py).

The public layout is the JAX package's: NHWC images in; in train mode
`(pred1, pred2, feat)` NHWC at the output stride, 16 by default (`(pred,
feat)` with one head); in eval mode (B, H, W, C) probabilities, the
average of the two heads' softmaxes after one align-corners upsample of
their concatenation (one head: its upsampled softmax). Inside, the model
permutes to NCHW once. The unfolded model takes the permuted view as it is:
channels-last memory, the layout the CLIs give its weights. A folded model
hands its encoder the input in its weights' layout, which
`fold_bn.folded_model` chooses by precision: NCHW-contiguous for float32
with TF32 off (cuDNN's FMA-unit kernels are NCHW-native, so no layout
transposes around the convs), channels-last for bf16, f16 or TF32 (the
tensor-core kernels are NHWC-native).

`dtype` works as in the JAX package: parameters stay float32, and the
forward computes in `dtype` (the input is cast at the model boundary).

On the mesh's spatial axis (`parallel.data_parallel` with a group whose
n_spatial > 1) the input and every output are this rank's block of the
image rows: the instance norm sums over the spatial group, and the eval
tail gathers the heads' logits to upsample the whole image's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from regda_tpu_torch.models.heads import ASPPClassifier, PPMBilinear
from regda_tpu_torch.models.resnet import BASIC_BLOCK_TYPES, BatchNorm2d, ResNetEncoder
from regda_tpu_torch.ops.resize import resize_rows_nchw
from regda_tpu_torch.parallel.mesh import DataGroup, check_height, spatial_sum


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  group: Optional[DataGroup] = None) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW, biased variance, in float32, by
    the JAX package's formula (x - mean) * rsqrt(var + eps). (`F.instance_norm`
    runs as a batch norm over B * C channels, whose kernels would blur the
    serve profile's check that folding left no batch-norm kernel.) The result
    is NCHW-contiguous, as `F.instance_norm`'s is: PyTorch's adaptive-pool
    kernel, which the heads run on it, is faster on that layout than on
    channels-last. On the spatial axis, x is a block of rows: the sum, then
    the sum of squared deviations from the image's mean, each summed over
    the spatial group (with the gradient)."""
    xf = x.to(torch.float32, memory_format=torch.contiguous_format)
    if group is None or not group.spatial:
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    n = xf.shape[2] * xf.shape[3] * group.n_spatial
    centred = xf - spatial_sum(xf.sum(dim=(2, 3), keepdim=True), group) / n
    var = spatial_sum((centred * centred).sum(dim=(2, 3), keepdim=True), group) / n
    return (centred * torch.rsqrt(var + eps)).to(x.dtype)


class DeeplabV2(nn.Module):
    def __init__(self, resnet_type: str = 'resnet101', num_classes: int = 6,
                 multi_layer: bool = True, use_ppm: bool = True,
                 is_ins_norm: bool = True, fc_dim: int = 2048, folded: bool = False,
                 dtype: torch.dtype = torch.float32, output_stride: int = 16,
                 remat: bool = False):
        super().__init__()
        self.resnet_type = resnet_type
        self.output_stride = output_stride
        self.num_classes = num_classes
        self.multi_layer = multi_layer
        self.use_ppm = use_ppm
        self.is_ins_norm = is_ins_norm
        self.fc_dim = fc_dim
        self.folded = folded
        self.dtype = dtype
        self.encoder = ResNetEncoder(resnet_type, folded, output_stride, remat)
        self.data_group = None     # the instance norm's and the tail's (parallel.data_parallel)

        def head():
            if use_ppm:
                return PPMBilinear(num_classes, fc_dim, folded)
            return ASPPClassifier(num_classes, fc_dim)

        if multi_layer:
            self.layer5 = head()
            self.layer6 = head()
        else:
            self.cls_pred = head()

    @property
    def remat(self) -> bool:
        """Whether training checkpoints the encoder's blocks; the encoder's
        ResNet holds the setting."""
        return self.encoder.resnet.remat

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> the encoder's NCHW map at the output stride in
        `dtype`, instance-normalized where the model says so. A folded model
        takes its input in the stem weight's layout (module docstring)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.folded:
            x = x.contiguous(memory_format=torch.contiguous_format
                             if self.encoder.resnet.conv1.weight.is_contiguous()
                             else torch.channels_last)
        feat = self.encoder(x)
        return instance_norm(feat, group=self.data_group) if self.is_ins_norm else feat

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (B, H, W, 3). Train: (pred1, pred2, feat) NHWC at the output
        stride, or (pred, feat) with one head, with head dropout drawn from
        `generator`.
        Eval: (B, H, W, C) probs."""
        if self.training and self.folded:
            raise RuntimeError('a folded DeeplabV2 is inference-only')
        hw = tuple(x.shape[1:3])
        group = self.data_group
        if group is not None and group.spatial:
            check_height(group, hw[0] * group.n_spatial, self.output_stride)
        feat = self.features(x)
        if not self.multi_layer:
            x1 = self.cls_pred(feat, generator)
            if self.training:
                return x1.permute(0, 2, 3, 1), feat.permute(0, 2, 3, 1)
            x1 = resize_rows_nchw(x1, hw, True, group)
            return torch.softmax(x1, dim=1).permute(0, 2, 3, 1)
        x1 = self.layer5(feat, generator)
        x2 = self.layer6(feat, generator)
        if self.training:
            return tuple(t.permute(0, 2, 3, 1) for t in (x1, x2, feat))
        return dual_head_probs(x1, x2, hw, group)


def dual_head_probs(x1: torch.Tensor, x2: torch.Tensor, hw: tuple[int, int],
                    group: Optional[DataGroup] = None) -> torch.Tensor:
    """The eval tail of the two heads: one align-corners upsample of their
    NCHW logits' concatenation (resize is per channel, so this equals two
    upsamples), then the mean of the per-head softmaxes, (B, H, W, C). On
    the spatial axis `hw` is this rank's block: the (B, 2C, h, w) logits are
    gathered over the spatial group and the rank's rows upsampled."""
    b, n = x1.shape[:2]
    both = torch.cat([x1, x2], dim=1).contiguous(memory_format=torch.channels_last)
    # channels-last in and out: the NHWC upsample kernel, and (B, H, W, 2, n)
    # softmaxes over contiguous rows; the sum of two values is their one add
    both = resize_rows_nchw(both, hw, True, group).permute(0, 2, 3, 1)
    return torch.softmax(both.reshape(b, *hw, 2, n), dim=-1).sum(-2) / 2


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: LeCun-normal conv kernels (std 1/sqrt(fan_in)),
    normal(0, 0.01) ASPP kernels, zero biases, unit BN scales, as the JAX
    package's Flax defaults."""
    aspp = {id(c) for m in model.modules() if isinstance(m, ASPPClassifier)
            for c in m.conv2d_list}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / (100.0 if id(m) in aspp else math.sqrt(fan_in)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()


def build_deeplabv2(model_name: str, num_classes: int,
                    dtype: torch.dtype = torch.float32,
                    generator: Optional[torch.Generator] = None,
                    **kw) -> DeeplabV2:
    """Model factory matching the reference tools (tools/train_src.py:58-80:
    MODEL='ResNet' means resnet50; resnet18/34 use a 512-wide fc_dim).
    Builds on the CPU; with `generator`, the weights are drawn from it."""
    name = model_name.lower()
    if name == 'resnet':
        name = 'resnet50'
    kw.setdefault('fc_dim', 512 if name in BASIC_BLOCK_TYPES else 2048)
    model = DeeplabV2(resnet_type=name, num_classes=num_classes, dtype=dtype, **kw)
    if generator is not None:
        init_weights(model, generator)
    return model
