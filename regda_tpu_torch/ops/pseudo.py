"""Online pseudo-label selection by per-class adaptive thresholds.

Counterpart of regda_tpu/ops/pseudo.py (reference: regda/gast/
pseudo_generation.py:59-93).
"""

from __future__ import annotations

from typing import Optional

import torch

from regda_tpu_torch.parallel.mesh import DataGroup, all_reduce_max


def pseudo_selection(probs: torch.Tensor, cutoff_top: float = 0.8,
                     cutoff_low: float = 0.6, ignore_label: int = -1,
                     group: Optional[DataGroup] = None) -> torch.Tensor:
    """probs (B, H, W, C) softmaxed -> (B, H, W) int32 hard labels: the one
    class above max(class_max * cutoff_top, cutoff_low); pixels where zero or
    several classes pass are ignored. On the spatial axis (`group`) the
    class maximum is the image's, over the ranks that hold its rows."""
    b, h, w, c = probs.shape
    p = probs.reshape(b, h * w, c)
    class_max = all_reduce_max(p.amax(dim=1, keepdim=True), group)
    class_thr = torch.clamp(class_max * cutoff_top, min=cutoff_low)  # (B,1,C)
    passed = (p > class_thr).to(torch.int32)                         # (B,HW,C)
    hard = torch.argmax(passed, dim=-1).to(torch.int32)
    hard = torch.where(passed.sum(dim=-1) == 1, hard, ignore_label)
    return hard.reshape(b, h, w).to(torch.int32)
