"""LRH — Local Region Homogenizing of pseudo-labels over SAM regions.

Counterpart of regda_tpu/ops/lrh.py (reference: regda/utils/
local_region_homog.py:99-152). Per region: the class histogram of the hard
pseudo-labels, its majority class and that class's share of the region's
valid pixels; a region whose share is below `percent` abstains, and
abstaining pixels and pixels of region 0 keep their own label.

The histogram is the CUDA kernel `ops/kernels/segment_hist.py` on the card
(its plain version on the CPU). Region ids outside [0, R) become region 0,
which abstains, exactly as in the JAX package (lrh.py:39-47,76).

On the mesh's spatial axis a rank holds a block of each image's rows: the
kernel counts that block, the (B, R, C) counts are summed over the ranks
that hold the image (an all-reduce of float32 whole numbers, exact below
2**24 a bin), and each rank votes its own pixels from the image's
histogram, which is the one-process histogram.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from regda_tpu_torch.ops.kernels.segment_hist import segment_hist_labels
from regda_tpu_torch.parallel.mesh import DataGroup

# Static bound on SAM region ids per tile (id 0 = unassigned).
MAX_REGIONS = 1024


def _clamp_regions(regions: torch.Tensor, num_regions: int) -> torch.Tensor:
    ok = (regions >= 0) & (regions < num_regions)
    return torch.where(ok, regions, 0).to(torch.int32).contiguous()


def region_histogram(label_onehot: torch.Tensor, regions: torch.Tensor,
                     num_regions: int = MAX_REGIONS) -> torch.Tensor:
    """(B, N, C) one-hot labels + (B, N) int region ids -> (B, R, C) counts.

    One-hot adapter over the label kernel (as segment_hist.py:100-106);
    all-zero rows are ignored pixels.
    """
    labels = torch.where(label_onehot.sum(-1) > 0, torch.argmax(label_onehot, -1), -1)
    return segment_hist_labels(labels.to(torch.int32).contiguous(),
                               _clamp_regions(regions, num_regions),
                               num_regions, label_onehot.shape[-1])


def homogenize(pseudo_labels: torch.Tensor, regions: torch.Tensor,
               percent: float = 0.5, num_classes: int = 6,
               ignore_label: int = -1,
               num_regions: int = MAX_REGIONS,
               group: Optional[DataGroup] = None) -> torch.Tensor:
    """pseudo_labels (B, H, W) int, regions (B, H, W) int -> (B, H, W) int32
    (on the spatial axis, `group`, this rank's rows of both).

    The histogram counts labels in [0, C), which is exactly what the
    reference's `one_hot_ignore` keeps, so the label form of the kernel is
    called directly.
    """
    if pseudo_labels.ndim != 3 or regions.shape != pseudo_labels.shape:
        raise ValueError(f'expected two equal (B, H, W) maps, got '
                         f'{tuple(pseudo_labels.shape)} and {tuple(regions.shape)}')
    b, h, w = pseudo_labels.shape
    labels_flat = pseudo_labels.reshape(b, h * w).to(torch.int32).contiguous()
    regions_flat = _clamp_regions(regions.reshape(b, h * w), num_regions)

    hist = segment_hist_labels(labels_flat, regions_flat, num_regions,
                               num_classes)                            # (B,R,C)
    if group is not None and group.spatial:
        dist.all_reduce(hist, group=group.spatial_pg)
    pixel_cnt = hist.sum(dim=-1)                                       # (B,R)
    max_cnt = hist.amax(dim=-1)
    max_cls = torch.argmax(hist, dim=-1).to(torch.int32)
    frac = max_cnt / (pixel_cnt + 1e-5)
    region_cls = torch.where(frac < percent, ignore_label, max_cls)   # (B,R)

    homog = torch.gather(region_cls, 1, regions_flat.long())           # (B,N)
    homog = torch.where(regions_flat == 0, ignore_label, homog)
    out = torch.where(homog == ignore_label, labels_flat, homog)
    return out.reshape(b, h, w).to(torch.int32)
