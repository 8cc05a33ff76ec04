"""Fused mask statistics of SAM's everything-mode: each budgeted low-res mask
logit resized to crop resolution by the composed resize matrices, thresholded
at 0, bit-packed, and reduced to its inclusive box and its area. The CUDA
kernel's wrapper and the plain version.

Replaces the Pallas TPU kernel `mask_stats_fused`
(regda_tpu/models/sam/pallas_stats.py:148) with `csrc/mask_stats.cu`; the
source note there says what bounds it on the card. `mask_stats_fused` takes
the kernel for CUDA tensors and `mask_stats_plain` (the counterpart of
`stats_one` in the reference's `_mask_stats_packed_fn`) for CPU tensors; any
other device raises, and so does a CUDA input that the kernel cannot take.
`launches` counts kernel launches (plain-version calls do not count).
Thresholding has no gradient.

Everything is float32, as the TPU kernel runs its products at the highest
precision: the result is thresholded at 0. The packed masks are
(M, ch, ceil(cw / 8)) uint8, the first pixel of a byte in its top bit
(`numpy.packbits` order; unpack with `np.unpackbits(bits, axis=-1)[..., :cw]`);
the TPU kernel pads the frame to its (8, 128) tiles, which this layout does
not. A slot whose `active` flag is 0 costs no resize and returns zero bits, a
zero box and a zero area (the TPU kernel leaves them undefined).
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._band import ResizeFrame
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `mask_stats_fused` in this process
launches = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., cw) bool -> (..., ceil(cw / 8)) uint8, `numpy.packbits` order."""
    cw = mask.shape[-1]
    pad = (-cw) % 8
    bits = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=mask.device)
    return (bits.reshape(*mask.shape[:-1], (cw + pad) // 8, 8) * weights).sum(-1).to(torch.uint8)


def unpack_bits(bits: torch.Tensor, cw: int) -> torch.Tensor:
    """(..., ceil(cw / 8)) uint8 -> (..., cw) uint8 of 0 and 1."""
    xi = torch.arange(cw, device=bits.device)
    shift = (7 - xi % 8).to(torch.uint8)
    return (bits[..., xi // 8] >> shift) & 1


def mask_stats_plain(logits, m_h, m_wt, ch: int, cw: int, active=None):
    """(M, SH, SW) logits, m_h (ch, SH), m_wt (SW, cw) -> (bits (M, ch,
    ceil(cw / 8)) uint8, boxes (M, 4) float32 [x0, y0, x1, y1] inclusive, areas
    (M,) float32), with dense float32 matmuls."""
    y = torch.matmul(torch.matmul(m_h.float(), logits.float()), m_wt.float())   # (M, ch, cw)
    mask = y > 0.0
    if active is not None:
        mask = mask & active.bool()[:, None, None]
    rows, cols = mask.any(dim=2), mask.any(dim=1)
    ys = torch.arange(ch, device=logits.device)
    xs = torch.arange(cw, device=logits.device)
    y0 = torch.where(rows, ys, ch).amin(dim=1)
    y1 = torch.where(rows, ys, -1).amax(dim=1)
    x0 = torch.where(cols, xs, cw).amin(dim=1)
    x1 = torch.where(cols, xs, -1).amax(dim=1)
    boxes = torch.stack([x0, y0, x1, y1], dim=1).float()
    empty = (y1 < y0) | (x1 < x0)
    boxes = torch.where(empty[:, None], torch.zeros_like(boxes), boxes)
    return pack_bits(mask), boxes, mask.sum(dim=(1, 2)).float()


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('mask_stats')
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mask_stats_launch.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
        lib.mask_stats_launch.restype = ctypes.c_int
        lib.mask_stats_error_string.argtypes = [ctypes.c_int]
        lib.mask_stats_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(logits, frame, active):
    global launches
    lib = _library()
    if not logits.is_contiguous():
        raise ValueError(f'mask_stats: logits must be contiguous, got strides '
                         f'{logits.stride()}')
    m, sh, sw = logits.shape
    ch, cw = frame.ch, frame.cw
    dev = logits.device
    bits = torch.empty((m, ch, (cw + 7) // 8), dtype=torch.uint8, device=dev)
    boxes = torch.empty((m, 4), dtype=torch.float32, device=dev)
    areas = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0 or ch == 0 or cw == 0:   # nothing to launch, and nothing counted
        return bits, boxes.zero_(), areas.zero_()
    h_start, h_taps, w_start, w_taps = frame.bands(torch.float32)
    flags = None if active is None else active.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mask_stats_launch(
            logits.data_ptr(), None if flags is None else flags.data_ptr(),
            h_start.data_ptr(), h_taps.data_ptr(), w_start.data_ptr(), w_taps.data_ptr(),
            bits.data_ptr(), boxes.data_ptr(), areas.data_ptr(), m, sh, sw, ch, cw,
            int(logits.dtype == torch.bfloat16), stream)
    if err == _INVALID_VALUE:
        raise ValueError(f'mask_stats: the kernel refused M = {m}, source {sh} x {sw}, '
                         f'frame {ch} x {cw}')
    if err:
        raise RuntimeError('mask_stats: kernel launch failed: '
                           + lib.mask_stats_error_string(err).decode())
    launches += 1
    return bits, boxes, areas


def mask_stats_fused(logits, frame: ResizeFrame, active=None):
    """(M, SH, SW) low-res mask logits (float32 or bfloat16) and the frame of
    the composed resize matrices m_h (ch, SH), m_w (cw, SW) -> (bits (M, ch,
    ceil(cw / 8)) uint8 crop-resolution mask bits, boxes (M, 4) float32 [x0,
    y0, x1, y1] in the inclusive max-index convention ([0, 0, 0, 0] for an
    empty mask), areas (M,) float32 pixel counts). active: optional (M,) bool
    or int; a slot whose flag is 0 returns zeros throughout."""
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'mask_stats: logits must be float32 or bfloat16, got {logits.dtype}')
    if not isinstance(frame, ResizeFrame):
        raise TypeError(f'mask_stats: the resize matrices come as a ResizeFrame, '
                        f'got {type(frame)}')
    if logits.ndim != 3 or (frame.sh, frame.sw) != tuple(logits.shape[1:]):
        raise ValueError(f'mask_stats: logits must be (M, SH, SW) and the resize matrices '
                         f'(ch, SH) and (cw, SW), got {tuple(logits.shape)}, '
                         f'({frame.ch}, {frame.sh}) and ({frame.cw}, {frame.sw})')
    if active is not None and tuple(active.shape) != (logits.shape[0],):
        raise ValueError(f'mask_stats: active must be ({logits.shape[0]},), '
                         f'got {tuple(active.shape)}')
    for what, device in (('the frame', frame.device),
                         ('active', None if active is None else active.device)):
        if device is not None and device != logits.device:
            raise ValueError(f'mask_stats: logits on {logits.device}, {what} on {device}')
    with span('kernel.mask_stats'):
        if logits.device.type == 'cuda':
            return _launch(logits, frame, active)
        if logits.device.type == 'cpu':
            return mask_stats_plain(logits, frame.m_h, frame.m_wt, frame.ch, frame.cw, active)
        raise ValueError(f'mask_stats: no kernel for device {logits.device}')
