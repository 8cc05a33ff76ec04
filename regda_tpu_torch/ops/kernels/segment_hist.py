"""Per-region class histogram: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel `segment_hist_labels_pallas`
(regda_tpu/ops/pallas/segment_hist.py:61) with `csrc/segment_hist.cu`; the
kernel's source note says what bounds it on the card and how it is laid out.

`segment_hist_labels` takes the kernel for CUDA tensors and the plain
`scatter_add_` version for CPU tensors; any other device raises. There is no
fallback: a CUDA input that the kernel cannot take raises (R * C beyond a
block's shared memory, ids not 16-byte aligned). A call is one kernel launch:
the kernel writes every count, so the output is not zeroed first. `launches`
counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `segment_hist_labels` in this process
launches = 0

MAX_PIXELS = 1 << 24  # counts stay exact in float32 below 2**24

_lib = None
_max_bins = {}   # device index -> largest R * C a block's shared memory holds


def segment_hist_labels_plain(labels: torch.Tensor, regions: torch.Tensor,
                              num_regions: int, num_classes: int) -> torch.Tensor:
    """Plain PyTorch version: (B, N) int labels, (B, N) int regions ->
    (B, R, C) float32 counts of pixels with 0 <= label < C, 0 <= region < R.

    Counterpart of the reference's `segment_sum` path (lrh.py:55-58)."""
    b = labels.shape[0]
    bins = num_regions * num_classes
    valid = ((labels >= 0) & (labels < num_classes)
             & (regions >= 0) & (regions < num_regions))
    # invalid pixels land in one extra bin that is dropped
    idx = torch.where(valid, regions.long() * num_classes + labels.long(), bins)
    out = torch.zeros((b, bins + 1), dtype=torch.float32, device=labels.device)
    out.scatter_add_(1, idx, valid.float())
    return out[:, :bins].reshape(b, num_regions, num_classes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('segment_hist')
        lib.segment_hist_labels_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.segment_hist_labels_launch.restype = ctypes.c_int
        lib.segment_hist_max_bins.argtypes = []
        lib.segment_hist_max_bins.restype = ctypes.c_int
        lib.segment_hist_error_string.argtypes = [ctypes.c_int]
        lib.segment_hist_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(labels: torch.Tensor, regions: torch.Tensor, num_regions: int,
           num_classes: int):
    if labels.dtype != torch.int32 or regions.dtype != torch.int32:
        raise TypeError(f'labels and regions must be int32, got '
                        f'{labels.dtype} and {regions.dtype}')
    if labels.ndim != 2 or labels.shape != regions.shape:
        raise ValueError(f'labels and regions must both be (B, N), got '
                         f'{tuple(labels.shape)} and {tuple(regions.shape)}')
    if labels.device != regions.device:
        raise ValueError(f'labels on {labels.device}, regions on {regions.device}')
    if not (labels.is_contiguous() and regions.is_contiguous()):
        raise ValueError('labels and regions must be contiguous')
    if labels.shape[1] >= MAX_PIXELS:
        raise ValueError(f'N = {labels.shape[1]} pixels per image must be below '
                         f'2**24 for exact float32 counts')
    if num_regions < 1 or num_classes < 1:
        raise ValueError(f'need R >= 1 and C >= 1, got {num_regions}, {num_classes}')


def _launch(labels, regions, num_regions, num_classes) -> torch.Tensor:
    global launches
    lib = _library()
    b, n = labels.shape
    dev = labels.device.index
    with torch.cuda.device(labels.device):
        if dev not in _max_bins:
            max_bins = lib.segment_hist_max_bins()
            if max_bins < 0:
                raise RuntimeError('segment_hist: ' + lib.segment_hist_error_string(
                    -max_bins).decode())
            _max_bins[dev] = max_bins
        if num_regions * num_classes > _max_bins[dev]:
            raise ValueError(
                f'R * C * 4 = {num_regions * num_classes * 4} bytes of histogram '
                f'exceed the {_max_bins[dev] * 4} bytes of shared memory a block can use')
        for t in (labels, regions):
            if t.data_ptr() % 16:
                raise ValueError('segment_hist: labels and regions must start '
                                 'on a 16-byte boundary')
        if b == 0 or n == 0:   # nothing to launch, and nothing counted
            return torch.zeros((b, num_regions, num_classes), dtype=torch.float32,
                               device=labels.device)
        # the kernel writes every count: no zeroing launch
        out = torch.empty((b, num_regions, num_classes), dtype=torch.float32,
                          device=labels.device)
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        err = lib.segment_hist_labels_launch(
            labels.data_ptr(), regions.data_ptr(), out.data_ptr(), b, n,
            num_regions, num_classes, stream)
    if err:
        raise RuntimeError('segment_hist kernel launch failed: '
                           + lib.segment_hist_error_string(err).decode())
    launches += 1
    return out


def segment_hist_labels(labels: torch.Tensor, regions: torch.Tensor,
                        num_regions: int, num_classes: int) -> torch.Tensor:
    """labels (B, N) int32 (ignore < 0), regions (B, N) int32 -> (B, R, C)
    float32 histogram. Only labels in [0, C) and regions in [0, R) count."""
    _check(labels, regions, num_regions, num_classes)
    with span('kernel.segment_hist'):
        if labels.device.type == 'cuda':
            return _launch(labels, regions, num_regions, num_classes)
        if labels.device.type == 'cpu':
            return segment_hist_labels_plain(labels, regions, num_regions, num_classes)
        raise ValueError(f'segment_hist: no kernel for device {labels.device}')
