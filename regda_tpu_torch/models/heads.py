"""Segmentation heads: PSPNet pyramid pooling (PPM) and the summed
dilated-conv ASPP classifier (counterparts of regda_tpu/models/heads.py,
reference regda/models/Encoder.py:8-84). NCHW inside the model.

Parameter names follow the reference: `ppm.<i>.1` (conv) and `ppm.<i>.2`
(BN) per pool scale; `conv_last.0` (3x3 conv), `.1` (BN), `.4` (classifier
conv with bias); `conv2d_list.<i>` for the ASPP branches. With
`folded=True` the PPM's BNs are `FoldedBias`es (models/fold_bn.py).

On the mesh's spatial axis (parallel/mesh.py) the PPM pools a rank's block
of rows into the whole map's bins and sums the parts over the spatial
group, so each rank holds the whole pooled maps; their upsample keeps
the rank's rows. The 3x3 convs take their halos (models/resnet.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from regda_tpu_torch.models.resnet import Conv2d, conv_norm, norm_layer
from regda_tpu_torch.ops.resize import adaptive_avg_pool_rows_nchw, resize_rows_nchw


class AdaptiveAvgPool(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale
        self.data_group = None

    def forward(self, x):
        return adaptive_avg_pool_rows_nchw(x, (self.scale, self.scale), self.data_group)


class Dropout2d(nn.Module):
    """Channel dropout (torch Dropout2d, Flax Dropout broadcast over H, W)
    drawing its mask from an explicit `torch.Generator`. Set `p` to 0 to
    switch it off. Inside a data-parallel step (`parallel.data_parallel`)
    each rank draws the global batch's mask and keeps the rows of its data
    coordinate, so that the ranks together draw what one process would
    and the ranks that hold the same images share their mask."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.data_group = None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        group, b = self.data_group, x.shape[0]
        rows = b if group is None else b * group.n_data
        mask = torch.bernoulli(
            torch.full((rows, x.shape[1], 1, 1), keep, device=x.device),
            generator=generator)
        if group is not None:
            mask = mask[group.data_rank * b:(group.data_rank + 1) * b]
        return x * (mask / keep).to(x.dtype)


POOL_SCALES = (1, 2, 3, 6)


class PPMBilinear(nn.Module):
    def __init__(self, num_classes: int = 6, fc_dim: int = 2048, folded: bool = False):
        super().__init__()
        self.ppm = nn.ModuleList([
            nn.Sequential(AdaptiveAvgPool(s), Conv2d(fc_dim, 512, 1, bias=False),
                          norm_layer(512, folded), nn.ReLU())
            for s in POOL_SCALES])
        self.data_group = None     # the upsample's rows (parallel.data_parallel)
        self.conv_last = nn.ModuleList([
            Conv2d(fc_dim + len(POOL_SCALES) * 512, 512, 3, padding=1, bias=False),
            norm_layer(512, folded), nn.ReLU(), Dropout2d(0.1),
            Conv2d(512, num_classes, 1)])

    def pooled(self, x) -> list:
        """x's adaptive average pools, one a branch, computed in float32 from
        one upcast of x and cast back to x's dtype."""
        xf = x.float()
        return [branch[0](xf).to(x.dtype) for branch in self.ppm]

    def pools(self, x, pooled: Optional[list] = None) -> list:
        """The pyramid: each branch's pooled map (`self.pooled(x)`, or given
        by a head that pools the same map) through its conv, norm and ReLU,
        upsampled back to x's size (on the spatial axis, x's rows of the
        whole map's upsample). The upsample reads the branch channels-last,
        which takes PyTorch's NHWC kernel: an NCHW branch (a folded float32
        model's, models/fold_bn.py) is copied, a channels-last one is not."""
        hw = tuple(x.shape[-2:])
        pooled = self.pooled(x) if pooled is None else pooled
        return [resize_rows_nchw(branch[1:](p).contiguous(memory_format=torch.channels_last),
                                 hw, False, self.data_group, whole=True)
                for branch, p in zip(self.ppm, pooled)]

    def forward(self, x, generator: Optional[torch.Generator] = None):
        conv, bn, _, dropout, classifier = self.conv_last
        y = conv_norm(conv, bn, torch.cat([x] + self.pools(x), dim=1), relu=True)
        return classifier(dropout(y, generator))


ASPP_DILATIONS = (6, 12, 18, 24)


class ASPPClassifier(nn.Module):
    """Summed parallel dilated 3x3 convs with bias (Classifier_Module,
    d = 6, 12, 18, 24)."""

    def __init__(self, num_classes: int = 6, in_ch: int = 2048):
        super().__init__()
        self.conv2d_list = nn.ModuleList([
            Conv2d(in_ch, num_classes, 3, padding=d, dilation=d) for d in ASPP_DILATIONS])

    def forward(self, x, generator: Optional[torch.Generator] = None):
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            out = out + conv(x)
        return out
