"""Exact stability counts of SAM's everything-mode: for each candidate mask,
the number of pixels of its logits, resized to crop resolution by the
composed resize matrices, above +offset and above -offset. The CUDA kernel's
wrappers and the plain version.

Replaces three Pallas TPU kernels of regda_tpu/models/sam/pallas_stability.py
with `csrc/stability.cu`: `stability_counts_fused` (:135) becomes the
interleaved entry, and `stability_counts_blocked` (:303) and
`stability_counts_blocked_v2` (:415) the blocked entry. The two blocked TPU
kernels compute one function and differ in how their matrix products are
arranged for that chip's matrix unit, so they share one entry here; their
`group`, `dense` and `interpret` arguments are TPU scheduling and have no
counterpart. The source note of the kernel says what bounds it on the card.

The wrappers take the kernel for CUDA tensors and `stability_counts_plain`
(the counterpart of `pallas_stability.stability_counts_xla`) for CPU tensors;
any other device raises, and so does a CUDA input that the kernel cannot
take. `launches_blocked` and `launches_fused` count kernel launches
(plain-version calls do not count). Counting has no gradient.

Precision, as in the TPU kernels: the matrices are rounded to the logits'
dtype, products are summed in float32, the row-resized intermediate is
rounded back to the logits' dtype, and the compare is on float32. A candidate
whose `active` flag is 0 costs no resize and returns two zeros (the TPU
kernels leave such counts undefined; callers AND with the same flag).
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._band import ResizeFrame
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `stability_counts_blocked` / `stability_counts_fused`
launches_blocked = 0
launches_fused = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def block_masks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(M, 4h, 4w) interleaved logits -> (M, 16h, w) blocked candidate layout:
    pixel (4y + 2dy + gy, 4x + 2dx + gx) goes to row (dy*8 + dx*4 + gy*2 + gx)*h
    + y, column x."""
    m = x.shape[0]
    y = x.reshape(m, h, 2, 2, w, 2, 2)             # (m, h, dy, gy, w, dx, gx)
    return y.permute(0, 2, 5, 3, 6, 1, 4).reshape(m, 16 * h, w)


def unblock_masks(blk: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(M, 16h, w) blocked candidate logits -> (M, 4h, 4w) interleaved."""
    m = blk.shape[0]
    x = blk.reshape(m, 2, 2, 2, 2, h, w)           # (m, dy, dx, gy, gx, h, w)
    return x.permute(0, 5, 1, 3, 6, 2, 4).reshape(m, 4 * h, 4 * w)


def stability_counts_plain(logits, m_h, m_wt, offset: float = 1.0, active=None,
                           group: int = 24):
    """(M, SH, SW) logits, m_h (ch, SH), m_wt (SW, cw) -> (inter (M,), union
    (M,)) float32 counts of resize(logits) > +-offset, `group` candidates at
    crop resolution at a time. Products of values rounded to the logits' dtype
    are exact in float32 for bfloat16, so the float32 matmuls below are the
    kernel's arithmetic up to the order of their sums."""
    dt = logits.dtype
    mh = m_h.to(dt).float()
    mwt = m_wt.to(dt).float()
    inter, union = [], []
    for lo in range(0, logits.shape[0], group):
        y1 = torch.matmul(mh, logits[lo:lo + group].float()).to(dt)
        y = torch.matmul(y1.float(), mwt)
        inter.append((y > offset).sum(dim=(-2, -1)))
        union.append((y > -offset).sum(dim=(-2, -1)))
    if not inter:
        zero = logits.new_zeros((0,), dtype=torch.float32)
        return zero, zero.clone()
    inter, union = torch.cat(inter).float(), torch.cat(union).float()
    if active is not None:
        on = active.bool()
        inter, union = inter * on, union * on
    return inter, union


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('stability')
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stability_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr]
        lib.stability_launch.restype = ctypes.c_int
        lib.stability_error_string.argtypes = [ctypes.c_int]
        lib.stability_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, x, frame, sh, sw, active):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: logits must be float32 or bfloat16, got {x.dtype}')
    if not isinstance(frame, ResizeFrame):
        raise TypeError(f'{name}: the resize matrices come as a ResizeFrame, got {type(frame)}')
    if (frame.sh, frame.sw) != (sh, sw):
        raise ValueError(f'{name}: the resize matrices must be (ch, {sh}) and (cw, {sw}), '
                         f'got ({frame.ch}, {frame.sh}) and ({frame.cw}, {frame.sw})')
    if active is not None and tuple(active.shape) != (x.shape[0],):
        raise ValueError(f'{name}: active must be ({x.shape[0]},), got {tuple(active.shape)}')
    for what, device in (('the frame', frame.device),
                         ('active', None if active is None else active.device)):
        if device is not None and device != x.device:
            raise ValueError(f'{name}: logits on {x.device}, {what} on {device}')


def _launch(name, x, frame, offset, active, blocked):
    """-> ((M, 2) counts, whether a kernel was launched)."""
    lib = _library()
    if not x.is_contiguous():
        raise ValueError(f'{name}: logits must be contiguous, got strides {x.stride()}')
    m, ch, cw = x.shape[0], frame.ch, frame.cw
    out = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    if m == 0 or ch == 0 or cw == 0:   # nothing to launch, and nothing counted
        return out.zero_(), False
    h_start, h_taps, w_start, w_taps = frame.bands(x.dtype)
    flags = None if active is None else active.to(torch.int32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stability_launch(
            x.data_ptr(), None if flags is None else flags.data_ptr(),
            h_start.data_ptr(), h_taps.data_ptr(), w_start.data_ptr(), w_taps.data_ptr(),
            out.data_ptr(), m, frame.sh, frame.sw, ch, cw, float(offset),
            int(x.dtype == torch.bfloat16), int(blocked), stream)
    if err == _INVALID_VALUE:
        raise ValueError(f'{name}: the kernel refused M = {m}, source {frame.sh} x {frame.sw}, '
                         f'frame {ch} x {cw}')
    if err:
        raise RuntimeError(f'{name}: kernel launch failed: '
                           + lib.stability_error_string(err).decode())
    return out, True


def stability_counts_blocked(blk, frame: ResizeFrame, h: int, w: int, offset: float = 1.0,
                             active=None):
    """(M, 16h, w) candidate-major blocked mask logits (the mask head's
    (B, M * 16, h * w) output reshaped, see `block_masks`) and the frame of
    the composed resize matrices m_h (ch, 4h), m_w (cw, 4w) -> (inter (M,),
    union (M,)) float32 counts of resize(masks) > +-offset over the (ch, cw)
    crop frame. The caller computes inter / max(union, 1). active: optional
    (M,) bool or int; a candidate whose flag is 0 returns zeros."""
    global launches_blocked
    name = 'stability_counts_blocked'
    if blk.ndim != 3 or blk.shape[1] != 16 * h or blk.shape[2] != w:
        raise ValueError(f'{name}: blk must be (M, {16 * h}, {w}), got {tuple(blk.shape)}')
    _check(name, blk, frame, 4 * h, 4 * w, active)
    with span('kernel.stability_blocked'):
        if blk.device.type == 'cuda':
            out, launched = _launch(name, blk, frame, offset, active, True)
            launches_blocked += launched
            return out[:, 0], out[:, 1]
        if blk.device.type == 'cpu':
            return stability_counts_plain(unblock_masks(blk, h, w), frame.m_h, frame.m_wt, offset,
                                          active)
        raise ValueError(f'{name}: no kernel for device {blk.device}')


def stability_counts_fused(logits, frame: ResizeFrame, offset: float = 1.0, active=None):
    """(M, SH, SW) interleaved low-res mask logits and the frame of the
    composed resize matrices m_h (ch, SH), m_w (cw, SW) -> (inter (M,), union
    (M,)) float32 counts, as `stability_counts_blocked`."""
    global launches_fused
    name = 'stability_counts_fused'
    if logits.ndim != 3:
        raise ValueError(f'{name}: logits must be (M, SH, SW), got {tuple(logits.shape)}')
    _check(name, logits, frame, *logits.shape[1:], active)
    with span('kernel.stability_fused'):
        if logits.device.type == 'cuda':
            out, launched = _launch(name, logits, frame, offset, active, False)
            launches_fused += launched
            return out[:, 0], out[:, 1]
        if logits.device.type == 'cpu':
            return stability_counts_plain(logits, frame.m_h, frame.m_wt, offset, active)
        raise ValueError(f'{name}: no kernel for device {logits.device}')
