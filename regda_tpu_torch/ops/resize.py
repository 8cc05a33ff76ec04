"""Bilinear resizes and adaptive average pooling on channel-last tensors.

Counterpart of regda_tpu/ops/resize.py, which builds separable interpolation
matrices because `jax.image.resize` lacks align-corners sampling. PyTorch has
the exact semantics natively, so these are `F.interpolate` /
`F.adaptive_avg_pool2d`. Like the reference, the arithmetic runs in float32
and the result is cast back to the input dtype; sums come out in another
order than the reference's matmuls, so results agree to float32 rounding.

The `*_nchw` forms are what the models call inside their NCHW interior.

`_interp_matrix_half_pixel` is the one matrix form the port keeps (numpy, as
in the reference): SAM's everything-mode composes the mask resize chain into
one matrix per axis from it (models/sam/auto.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=128)
def _interp_matrix_half_pixel(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 matrix of 1-D linear interpolation with
    half-pixel centers (`align_corners=False`), edge-clamped: two taps a row."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, max(n_in - 2, 0))
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    m = np.zeros((n_out, n_in), dtype=np.float32)
    np.add.at(m, (np.arange(n_out), lo), (1.0 - frac).astype(np.float32))
    np.add.at(m, (np.arange(n_out), hi), frac.astype(np.float32))
    return m


def bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                  align_corners: bool) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H', W') bilinear resize computed in float32."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    y = F.interpolate(x.float(), size=tuple(out_hw), mode='bilinear',
                      align_corners=align_corners)
    return y.to(x.dtype)


def adaptive_avg_pool_nchw(x: torch.Tensor,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) AdaptiveAvgPool2d computed in float32."""
    return F.adaptive_avg_pool2d(x.float(), tuple(out_hw)).to(x.dtype)


def _channel_last(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """Apply an NCHW op to (..., H, W, C), keeping the leading dims."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = fn(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), *args)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], c)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=True) on (..., H, W, C)."""
    if tuple(x.shape[-3:-1]) == tuple(out_hw):
        return x
    return _channel_last(bilinear_nchw, x, out_hw, True)


def resize_bilinear_half_pixel(x: torch.Tensor,
                               out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on (..., H, W, C)."""
    if tuple(x.shape[-3:-1]) == tuple(out_hw):
        return x
    return _channel_last(bilinear_nchw, x, out_hw, False)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d on channel-last (..., H, W, C)."""
    return _channel_last(adaptive_avg_pool_nchw, x, out_hw)
