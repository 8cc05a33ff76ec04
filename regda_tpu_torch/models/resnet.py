"""Dilated ResNet encoder (counterpart of regda_tpu/models/resnet.py).

BasicBlock (resnet18/34) and Bottleneck (resnet50/101/152), with the stride-2
3x3 convs of layer4 turned into dilated stride-1 convs (reference:
regda/resnet.py:192-207). Parameter names follow the reference's torch
state_dict (`encoder.resnet.layer1.0.conv1.weight`, ...).

`output_stride` 16 (the configuration every RegDA tool builds) gives
layer4 stride 1, its first block dilation 1 and the rest dilation 2; 8
dilates layer3 too, and 32 dilates nothing (`stage_plan`, a copy of the JAX
package's `_stage_plan`). The stem is the plain 7x7/2 conv; the JAX
package's space-to-depth rewrite (`StemConv`) exists for the TPU's matrix
unit and gives the identical result.

`remat=True` (the reference's `with_cp`, regda/resnet.py:140-168; the JAX
package's `nn.remat` around each block) checkpoints every residual block
while the model trains with grad enabled: the backward recomputes a
block's activations from its input instead of keeping them. The recompute
runs with the block's BatchNorms' running-statistics update switched off,
so the statistics move once a forward, as without remat.

`folded=True` builds the inference-only encoder of a model whose BatchNorm
affines were folded into their convs (models/fold_bn.py): each BN becomes a
`FoldedBias`, a bare per-channel bias, which the conv before it adds in its
epilogue (`conv_bias_act`). Training never uses it.

Two layers carry the JAX package's semantics rather than torch's defaults:
  * `Conv2d` computes in its input's dtype with float32 parameters, as a
    Flax `nn.Conv(dtype=...)` does: bf16 input means bf16 compute.
  * `BatchNorm2d` updates its running variance with the *biased* batch
    variance at momentum 0.9 (Flax `BatchNorm(momentum=0.9)`), where
    `torch.nn.BatchNorm2d` uses the unbiased one. It has no
    `num_batches_tracked`, as the Flax collection has none. Inside a
    data-parallel step (`parallel.data_parallel`) it takes its batch
    statistics over the global batch of every rank, as the JAX step under
    GSPMD does (`_global_forward`); in a group of one rank those are the
    rank's own, and the plain path (cuDNN's batch norm on the card) runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from regda_tpu_torch.parallel.mesh import all_reduce_sum

RESNET_DEPTHS = {
    'resnet18': (2, 2, 2, 2),
    'resnet34': (3, 4, 6, 3),
    'resnet50': (3, 4, 6, 3),
    'resnet101': (3, 4, 23, 3),
    'resnet152': (3, 8, 36, 3),
}
BASIC_BLOCK_TYPES = ('resnet18', 'resnet34')


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.Module):
    """BatchNorm with Flax's running-statistics rule (see module docstring)."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        # False while a checkpointed block recomputes its forward
        self.update_stats = True
        # the DataGroup of a data-parallel step (parallel.data_parallel)
        self.data_group = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.data_group is not None and self.data_group.size > 1:
            return self._global_forward(x)
        if x.numel() == x.shape[1]:
            # one value per channel (a pooled PPM branch at batch 1):
            # F.batch_norm refuses it, Flax normalizes it to zero, so the
            # output is the bias, as the formula below gives
            centred = x - x.mean(dim=(0, 2, 3), keepdim=True)
            y = (centred * self.eps ** -0.5 * self.weight.view(-1, 1, 1)
                 + self.bias.view(-1, 1, 1))
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return y

    def _global_forward(self, x):
        """Train mode over the global batch of `self.data_group`: the
        per-channel sum, then the sum of squared deviations from the global
        mean, each all-reduced (their backward all-reduces the statistics'
        gradients); the biased variance, as above. With one value per
        channel in the whole global batch the deviation is 0 and the
        output is the bias, as in the one-process branch; a rank that holds
        one value per channel of several normalizes by the global ones."""
        group = self.data_group
        c = x.shape[1]
        xf = x.float()
        n = xf.numel() // c * group.size
        mean = all_reduce_sum(xf.sum(dim=(0, 2, 3)), group) / n
        centred = xf - mean.view(1, c, 1, 1)
        var = all_reduce_sum((centred * centred).sum(dim=(0, 2, 3)), group) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (centred * scale.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return y


class FoldedBias(nn.Module):
    """Stand-in for an eval BatchNorm whose affine was folded into the conv
    before it: the per-channel bias t = beta - mean * s that remains
    (regda_tpu/models/fold_bn.py:FoldedBias). Its one parameter, `bias`,
    keeps the BN's state_dict name."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        return x + self.bias.to(x.dtype).view(-1, 1, 1)


def norm_layer(num_features: int, folded: bool) -> nn.Module:
    return FoldedBias(num_features) if folded else BatchNorm2d(num_features)


def conv_bias_act(x, weight, bias, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                  relu: bool = False, residual=None):
    """conv(x, weight) + bias (+ residual), then ReLU where asked, with weight
    and bias cast to x's dtype. On a CUDA tensor, a ReLU'd result comes from
    one cuDNN call that adds the bias and the residual in the convolution's
    epilogue (`torch.cudnn_convolution_relu` / `_add_relu`), so the folded
    eval runs no elementwise pass of its own; elsewhere, the plain ops."""
    weight, bias = weight.to(x.dtype), bias.to(x.dtype)
    if x.is_cuda and relu:
        if residual is None:
            return torch.cudnn_convolution_relu(x, weight, bias, stride, padding, dilation, 1)
        return torch.cudnn_convolution_add_relu(x, weight, residual, 1.0, bias,
                                                stride, padding, dilation, 1)
    y = F.conv2d(x, weight, bias, stride, padding, dilation)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def conv_norm(conv: Conv2d, norm: nn.Module, x, relu: bool, residual=None):
    """norm(conv(x)) (+ residual), then ReLU where asked. A folded norm's
    bias goes into the convolution (`conv_bias_act`)."""
    if isinstance(norm, FoldedBias):
        return conv_bias_act(x, conv.weight, norm.bias, conv.stride, conv.padding,
                             conv.dilation, relu, residual)
    y = norm(conv(x))
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def conv_bn(in_ch: int, out_ch: int, stride: int = 1, folded: bool = False) -> nn.Sequential:
    """The 1x1 projection shortcut (`downsample.0` conv, `downsample.1` BN)."""
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, bias=False),
                         norm_layer(out_ch, folded))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_proj: bool = False, folded: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = norm_layer(planes, folded)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn2 = norm_layer(planes, folded)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = norm_layer(planes * 4, folded)
        self.downsample = conv_bn(in_ch, planes * 4, stride, folded) if has_proj else None

    def forward(self, x):
        y = conv_norm(self.conv1, self.bn1, x, relu=True)
        y = conv_norm(self.conv2, self.bn2, y, relu=True)
        idt = x if self.downsample is None else conv_norm(*self.downsample, x, relu=False)
        return conv_norm(self.conv3, self.bn3, y, relu=True, residual=idt)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_proj: bool = False, folded: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride, dilation, dilation, bias=False)
        self.bn1 = norm_layer(planes, folded)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = norm_layer(planes, folded)
        self.downsample = conv_bn(in_ch, planes, stride, folded) if has_proj else None

    def forward(self, x):
        y = conv_norm(self.conv1, self.bn1, x, relu=True)
        idt = x if self.downsample is None else conv_norm(*self.downsample, x, relu=False)
        return conv_norm(self.conv2, self.bn2, y, relu=True, residual=idt)


def stage_plan(output_stride: int) -> tuple[tuple[int, int, int], ...]:
    """(stride, first-block dilation, later-block dilation) for layer1..4,
    per the reference's `_nostride_dilate` (regda/resnet.py:192-207)."""
    if output_stride == 32:
        return ((1, 1, 1), (2, 1, 1), (2, 1, 1), (2, 1, 1))
    if output_stride == 16:
        return ((1, 1, 1), (2, 1, 1), (2, 1, 1), (1, 1, 2))
    if output_stride == 8:
        return ((1, 1, 1), (2, 1, 1), (1, 1, 2), (1, 2, 4))
    raise ValueError('output_stride must be 8, 16 or 32.')


@contextlib.contextmanager
def _stats_frozen(block: nn.Module):
    """The block's BatchNorms leave their running statistics alone inside."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def _checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _stats_frozen(block)))


class ResNet(nn.Module):
    """NCHW in, the last stage's (B, C, H/os, W/os) feature map out."""

    def __init__(self, resnet_type: str = 'resnet101', folded: bool = False,
                 output_stride: int = 16, remat: bool = False):
        super().__init__()
        plan = stage_plan(output_stride)
        block = BasicBlock if resnet_type in BASIC_BLOCK_TYPES else Bottleneck
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = norm_layer(64, folded)
        in_ch, planes = 64, 64
        for stage, (n_blocks, (stride, d0, d1)) in enumerate(
                zip(RESNET_DEPTHS[resnet_type], plan), 1):
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(
                    in_ch, planes, stride if b == 0 else 1, d0 if b == 0 else d1,
                    has_proj=b == 0 and (stride != 1 or in_ch != planes * block.expansion),
                    folded=folded))
                in_ch = planes * block.expansion
            setattr(self, f'layer{stage}', nn.Sequential(*blocks))
            planes *= 2
        self.out_channels = in_ch

    def forward(self, x):
        x = conv_norm(self.conv1, self.bn1, x, relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = _checkpointed(block, x) if remat else block(x)
        return x


class ResNetEncoder(nn.Module):
    """Holds the body as `resnet`, giving the reference's `encoder.resnet.*` keys."""

    def __init__(self, resnet_type: str = 'resnet101', folded: bool = False,
                 output_stride: int = 16, remat: bool = False):
        super().__init__()
        self.resnet = ResNet(resnet_type, folded, output_stride, remat)

    def forward(self, x):
        return self.resnet(x)
