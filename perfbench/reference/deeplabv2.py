"""Plain PyTorch reference of the `deeplabv2-r101-regda` configuration: the
DeepLab-v2 segmenter of RegDA (regda/models/Encoder.py), a dilated ResNet
(He et al., arXiv:1512.03385; DeepLab-v2, Chen et al., arXiv:1606.00915)
at output stride 16 under two PSPNet pyramid-pooling heads and an instance
norm of the features. NCHW, float32, stock modules and functional calls,
no kernel of the program and nothing imported from it.

Parameter names are the reference state_dict's (`encoder.resnet.layer1.0.
conv1.weight`, `layer5.ppm.0.1.weight`, `layer5.conv_last.4.bias`), which
the program loads too, so one seeded state_dict feeds both.

Departures from torch's defaults, each the recipe's: BatchNorm eps 1e-5
with no `num_batches_tracked`; the heads' channel dropout draws its mask
with `torch.bernoulli` from the generator the benchmark gives, one
(B, 512, 1, 1) draw a head, head 5 before head 6, so that the reference
and the program, handed generators of one seed, drop the same channels.
Running statistics are not updated in training: no compared number reads
them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

DEPTHS = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3),
          'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3)}
BASIC = ('resnet18', 'resnet34')
# (stride, first block's dilation, later blocks' dilation) of layer1..4 at OS 16
PLAN_OS16 = ((1, 1, 1), (2, 1, 1), (2, 1, 1), (1, 1, 2))
EPS = 1e-5


class BN(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer('running_mean', torch.zeros(n))
        self.register_buffer('running_var', torch.ones(n))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, EPS)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, EPS)


def conv(cin, cout, k, stride=1, dilation=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, dilation * (k // 2), dilation, bias=bias)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, dilation, proj):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, planes, 1), BN(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, stride, dilation), BN(planes)
        self.conv3, self.bn3 = conv(planes, planes * 4, 1), BN(planes * 4)
        self.downsample = (nn.Sequential(conv(cin, planes * 4, 1, stride), BN(planes * 4))
                           if proj else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, dilation, proj):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, planes, 3, stride, dilation), BN(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3), BN(planes)
        self.downsample = (nn.Sequential(conv(cin, planes, 1, stride), BN(planes))
                           if proj else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, kind: str):
        super().__init__()
        block = Basic if kind in BASIC else Bottleneck
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False), BN(64)
        cin, planes = 64, 64
        for i, (n, (stride, d0, d1)) in enumerate(zip(DEPTHS[kind], PLAN_OS16), 1):
            blocks = []
            for b in range(n):
                blocks.append(block(cin, planes, stride if b == 0 else 1, d0 if b == 0 else d1,
                                    b == 0 and (stride != 1 or cin != planes * block.expansion)))
                cin = planes * block.expansion
            setattr(self, f'layer{i}', nn.Sequential(*blocks))
            planes *= 2
        self.out_channels = cin

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class Encoder(nn.Module):
    def __init__(self, kind):
        super().__init__()
        self.resnet = ResNet(kind)


class PPMHead(nn.Module):
    """PSPNet pyramid pooling (scales 1, 2, 3, 6) and the 3x3 classifier."""

    def __init__(self, num_classes, fc_dim, scales=(1, 2, 3, 6), width=512, dropout=0.1):
        super().__init__()
        self.scales, self.dropout = scales, dropout
        self.ppm = nn.ModuleList([nn.Sequential(nn.AdaptiveAvgPool2d(s), conv(fc_dim, width, 1),
                                                BN(width), nn.ReLU()) for s in scales])
        self.conv_last = nn.Sequential(conv(fc_dim + len(scales) * width, width, 3), BN(width),
                                       nn.ReLU(), nn.Identity(),
                                       conv(width, num_classes, 1, bias=True))

    def forward(self, x, generator: Optional[torch.Generator]):
        hw = x.shape[-2:]
        pools = [F.interpolate(branch(x), hw, mode='bilinear', align_corners=False)
                 for branch in self.ppm]
        c, bn, relu, _, cls = self.conv_last
        y = relu(bn(c(torch.cat([x] + pools, 1))))
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.bernoulli(torch.full((y.shape[0], y.shape[1], 1, 1), keep,
                                              device=y.device), generator=generator)
            y = y * (mask / keep)
        return cls(y)


class DeepLabV2(nn.Module):
    """x (B, 3, H, W) -> train: (logits 1, logits 2, features) at stride 16;
    eval: (B, C, H, W) the mean of both heads' softmaxes after an
    align-corners upsample."""

    def __init__(self, backbone='resnet101', num_classes=6, fc_dim=2048, **head):
        super().__init__()
        self.encoder = Encoder(backbone)
        self.layer5 = PPMHead(num_classes, fc_dim, **head)
        self.layer6 = PPMHead(num_classes, fc_dim, **head)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feat = F.instance_norm(self.encoder.resnet(x), eps=EPS)
        x1, x2 = self.layer5(feat, generator), self.layer6(feat, generator)
        if self.training:
            return x1, x2, feat
        hw = x.shape[-2:]
        p1 = F.interpolate(x1, hw, mode='bilinear', align_corners=True).softmax(1)
        p2 = F.interpolate(x2, hw, mode='bilinear', align_corners=True).softmax(1)
        return (p1 + p2) / 2


def build(model_cfg: dict) -> DeepLabV2:
    """The reference model of a configuration's `model` group."""
    return DeepLabV2(model_cfg['backbone'], model_cfg['num_classes'], model_cfg['fc_dim'],
                     scales=tuple(model_cfg['ppm_scales']), width=model_cfg['ppm_dim'],
                     dropout=model_cfg['head_dropout'])


def shapes(model_cfg: dict) -> dict:
    """name -> shape of the configuration's state_dict."""
    with torch.device('meta'):
        model = build(model_cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's convolutions and cuBLAS's matmuls in TF32 inside, or not: the
    reference holds float32 as float32 unless the control asks for TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
