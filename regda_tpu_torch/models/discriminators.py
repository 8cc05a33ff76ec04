"""Patch discriminators for adversarial adaptation (counterpart of
regda_tpu/models/discriminators.py).

References (not on the regda main path): regda/models/Discriminator.py:4-28
(`FCDiscriminator`), :31-57 (`FCDiscriminator_Local`), :60-78
(`PixelDiscriminator`). Channel-last in and out, as in the JAX package; the
convolutions run NCHW inside. Parameter names are the JAX package's module
names (`conv1` ... `classifier`, `d1`, `d2`, `cls1`, `cls2`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from regda_tpu_torch.ops.resize import resize_bilinear_half_pixel


def _stride2(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1)


class FCDiscriminator(nn.Module):
    """DCGAN-style patch discriminator over (B, H, W, in_channels) maps:
    five stride-2 4x4 convs -> (B, H/32, W/32, 1)."""

    def __init__(self, in_channels: int, ndf: int = 64):
        super().__init__()
        widths = (in_channels, ndf, ndf * 2, ndf * 4, ndf * 8)
        for i in range(4):
            setattr(self, f'conv{i + 1}', _stride2(widths[i], widths[i + 1]))
        self.classifier = _stride2(ndf * 8, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.leaky_relu(getattr(self, f'conv{i + 1}')(x), 0.2)
        return self.classifier(x).permute(0, 2, 3, 1)


class FCDiscriminatorLocal(nn.Module):
    """The local variant, fed [logits, features] (C = classes + 2048):
    three stride-2 convs and a stride-2 1-channel classifier, upsampled 32x
    (half-pixel bilinear) (Discriminator.py:31-57)."""

    def __init__(self, in_channels: int, ndf: int = 64):
        super().__init__()
        widths = (in_channels, ndf, ndf * 2, ndf * 4)
        for i in range(3):
            setattr(self, f'conv{i + 1}', _stride2(widths[i], widths[i + 1]))
        self.classifier = _stride2(ndf * 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f'conv{i + 1}')(x), 0.2)
        x = self.classifier(x).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        return resize_bilinear_half_pixel(x, (h * 32, w * 32))


class PixelDiscriminator(nn.Module):
    """Stride-1 per-pixel discriminator: the two heads' (source, target)
    class maps concatenated on the channels (Discriminator.py:60-78)."""

    def __init__(self, in_channels: int, ndf: int = 512, num_classes: int = 1):
        super().__init__()
        self.d1 = nn.Conv2d(in_channels, ndf, 3, padding=1)
        self.d2 = nn.Conv2d(ndf, ndf // 2, 3, padding=1)
        self.cls1 = nn.Conv2d(ndf // 2, num_classes, 3, padding=1)
        self.cls2 = nn.Conv2d(ndf // 2, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.leaky_relu(self.d2(F.leaky_relu(self.d1(x), 0.2)), 0.2)
        return torch.cat([self.cls1(x), self.cls2(x)], dim=1).permute(0, 2, 3, 1)
