"""Bilinear resizes and adaptive average pooling on channel-last tensors.

Counterpart of regda_tpu/ops/resize.py, which builds separable interpolation
matrices because `jax.image.resize` lacks align-corners sampling. PyTorch has
the exact semantics natively, so these are `F.interpolate` /
`F.adaptive_avg_pool2d`. Like the reference, the arithmetic runs in float32
and the result is cast back to the input dtype; sums come out in another
order than the reference's matmuls, so results agree to float32 rounding.

The `*_nchw` forms are what the models call inside their NCHW interior.

On the mesh's spatial axis (parallel/mesh.py) a rank holds a block of an
image's rows, and a resize reads the whole image: `resize_rows` and
`resize_rows_nchw` gather the input's height over the spatial group
(`gather_height`, which carries the gradient), resize to the whole
output and keep this rank's rows, so that they are the rows of the
one-process resize. `adaptive_avg_pool_rows_nchw` pools such blocks into
the whole image's bins. Without a spatial group they are the plain ops.

`_interp_matrix_half_pixel` is the one matrix form the port keeps (numpy, as
in the reference): SAM's everything-mode composes the mask resize chain into
one matrix per axis from it (models/sam/auto.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from regda_tpu_torch.parallel.mesh import DataGroup, gather_height, spatial_sum


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


def resize_rows_nchw(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool,
                     group: Optional[DataGroup], whole: bool = False) -> torch.Tensor:
    """(B, C, h, W) rows of this rank (or, with `whole`, a map that every
    spatial rank holds whole) -> this rank's `out_hw` = (rows, W') block of
    the image resized to (n_spatial * rows, W'), computed in float32."""
    if group is None or not group.spatial:
        return bilinear_nchw(x, out_hw, align_corners)
    if not whole:
        x = gather_height(x, group)
    h = out_hw[0]
    y = bilinear_nchw(x, (h * group.n_spatial, out_hw[1]), align_corners)
    return y[:, :, group.spatial_rank * h:(group.spatial_rank + 1) * h]


def adaptive_avg_pool_nchw(x: torch.Tensor,
                           out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) AdaptiveAvgPool2d computed in float32."""
    return F.adaptive_avg_pool2d(x.float(), tuple(out_hw)).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _bin_means(n_in: int, n_out: int, lo: int, hi: int) -> np.ndarray:
    """(n_out, hi - lo) float32: row i averages AdaptiveAvgPool's bin i,
    [floor(i n_in / n_out), ceil((i + 1) n_in / n_out)), of an axis of
    n_in, over its entries lo..hi - 1."""
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        a, b = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
        m[i, a:b] = 1.0 / (b - a)
    return m[:, lo:hi].astype(np.float32)


def adaptive_avg_pool_rows_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                                group: Optional[DataGroup]) -> torch.Tensor:
    """`adaptive_avg_pool_nchw` of the whole image from (B, C, h, W) rows of
    this rank: each bin's share of this rank's rows, on the whole image's
    bins, summed over the spatial group (with the gradient). Every spatial
    rank gets the whole (B, C, out_h, out_w) pool."""
    if group is None or not group.spatial:
        return adaptive_avg_pool_nchw(x, out_hw)
    h, w = x.shape[-2:]
    lo = group.spatial_rank * h
    rows = torch.from_numpy(_bin_means(h * group.n_spatial, out_hw[0], lo, lo + h)).to(x.device)
    cols = torch.from_numpy(_bin_means(w, out_hw[1], 0, w)).to(x.device)
    part = torch.matmul(torch.matmul(rows, x.float()), cols.T)
    return spatial_sum(part, group).to(x.dtype)


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


def resize_rows(x: torch.Tensor, out_hw: tuple[int, int],
                group: Optional[DataGroup]) -> torch.Tensor:
    """`resize_bilinear_align_corners` of the whole image on (..., h, W, C)
    rows of this rank, to its `out_hw` block of the output's rows."""
    if group is None or not group.spatial:
        return resize_bilinear_align_corners(x, out_hw)
    return _channel_last(resize_rows_nchw, x, out_hw, True, group)


def resize_bilinear_half_pixel(x: torch.Tensor,
                               out_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on (..., H, W, C)."""
    if tuple(x.shape[-3:-1]) == tuple(out_hw):
        return x
    return _channel_last(bilinear_nchw, x, out_hw, False)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d on channel-last (..., H, W, C)."""
    return _channel_last(adaptive_avg_pool_nchw, x, out_hw)
