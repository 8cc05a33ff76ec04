"""Single-head DeepLabv2 with a global-pool reduction branch for the MMD
loss (counterpart of regda_tpu/models/deeplab_mmd.py).

Reference: regda/models/Deeplabv2_MMD.py:8-56 (`ReductionLayer`,
`Deeplabv2_MMD`; no regda tool builds it). In train mode the forward gives
the ASPP head's logits upsampled (bilinear, align corners) to the input and
the (B, inchannels / 8) reduced global feature for `ops.losses.mmd_loss`;
in eval mode the softmax probabilities. NHWC in and out; the port's encoder
and ASPP head inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from regda_tpu_torch.models.heads import ASPPClassifier
from regda_tpu_torch.models.resnet import ResNetEncoder
from regda_tpu_torch.ops.resize import resize_bilinear_align_corners


class ReductionLayer(nn.Module):
    """Global average pool -> inchannels / 4 -> inchannels / 8, ReLU after
    each (Deeplabv2_MMD.py:8-24)."""

    def __init__(self, inchannels: int = 2048):
        super().__init__()
        self.l1 = nn.Linear(inchannels, inchannels // 4)
        self.l2 = nn.Linear(inchannels // 4, inchannels // 8)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = feat.mean(dim=(2, 3))                     # NCHW -> (B, C)
        return torch.relu(self.l2(torch.relu(self.l1(x))))


class DeeplabV2MMD(nn.Module):
    def __init__(self, resnet_type: str = 'resnet50', output_stride: int = 16,
                 num_classes: int = 7, inchannels: int = 2048):
        super().__init__()
        self.encoder = ResNetEncoder(resnet_type, output_stride=output_stride)
        self.reduction_layer = ReductionLayer(inchannels)
        self.cls_pred = ASPPClassifier(num_classes, inchannels)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 3). Train: (logits (B, H, W, C), reduced (B, K / 8));
        eval: (B, H, W, C) probabilities."""
        hw = tuple(x.shape[1:3])
        feat = self.encoder(x.permute(0, 3, 1, 2))
        reduced = self.reduction_layer(feat)
        logits = resize_bilinear_align_corners(self.cls_pred(feat).permute(0, 2, 3, 1), hw)
        if self.training:
            return logits, reduced
        return torch.softmax(logits, dim=-1)
