"""SAM's mask head fused: upscaling (two 2x2/stride-2 transposed convs with a
LayerNorm2d and two gelus) and the hypernetwork product. The CUDA kernels'
wrapper and the plain version.

Replaces the Pallas TPU kernel `upscale_hyper_masks`
(regda_tpu/models/sam/pallas_upscale.py:224) with `csrc/upscale.cu`; the
source note there says what bounds it on the card and how the two kernels
(bfloat16 on the tensor cores, float32 on the ordinary units) are laid out.

`upscale_hyper_masks` takes the kernel for CUDA tensors and `upscale_plain`
(the counterpart of `pallas_upscale._upscale_stock`) for CPU tensors; any
other device raises. There is no fallback: a CUDA input that the kernel
cannot take raises. `launches` counts kernel launches (plain-version calls do
not count). The gradient differentiates the plain version, as the JAX
`custom_vjp` does; the gated (`active`) and the `blocked` calls are
inference-only, as in the JAX package.

Layouts are the JAX package's: src (B, H, W, C), hyper_in (B, M, C // 8),
k1 (C, 4 * (C // 4)) and k2 (C // 4, 4 * (C // 8)) the flattened transposed
convs with column blocks (dy, dx, f), b1 (1, 4 * (C // 4)) and b2
(1, 4 * (C // 8)) the 4x-tiled float32 biases, lnw and lnb (1, C // 4) the
LayerNorm2d affine. The compute dtype is k1's. The kernel is built for
C = 256 (SAM's decoder width) and M <= 4.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._autograd import grad_through_plain
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `upscale_hyper_masks` in this process
launches = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def _interleave(out: torch.Tensor, b: int, h: int, w: int, m: int) -> torch.Tensor:
    """(B, HW, M * 16) pixel-major masks -> (B, M, 4H, 4W); col = (m, dy, dx, gy, gx)."""
    masks = out.reshape(b, h, w, m, 2, 2, 2, 2).permute(0, 3, 1, 4, 6, 2, 5, 7)
    return masks.reshape(b, m, 4 * h, 4 * w)


def masks_from_blocked(out_t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Candidate-major blocked masks (B, M * 16, HW) -> (B, M, 4H, 4W): pixel
    (4y + 2dy + gy, 4x + 2dx + gx) of mask m is
    out_t[b, m * 16 + dy * 8 + dx * 4 + gy * 2 + gx, y * w + x]."""
    b, m = out_t.shape[0], out_t.shape[1] // 16
    x = out_t.reshape(b, m, 2, 2, 2, 2, h, w)       # (b, m, dy, dx, gy, gx, h, w)
    return x.permute(0, 1, 6, 2, 4, 7, 3, 5).reshape(b, m, 4 * h, 4 * w)


def upscale_plain(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype=torch.float32,
                  active=None, blocked: bool = False) -> torch.Tensor:
    """The mask head with the kernel's rounding points: products accumulate
    in float32 (float32 products of rounded values are exact for bfloat16),
    the LayerNorm moments are the two-pass float32 ones of the unrounded
    first product, its result and the second product are rounded to the
    compute dtype before each gelu, the gelu is the exact erf form, and the
    hypernetwork product is a float32 sum rounded to `out_dtype`."""
    b, h, w, c = src.shape
    m, c8 = hyper_in.shape[1:]
    c4 = k1.shape[1] // 4
    dt = k1.dtype
    x = src.reshape(b, h * w, c).to(dt)
    t1 = (x.float() @ k1.float() + b1[0].float()).reshape(b, h * w, 4, c4)
    mu = t1.mean(-1, keepdim=True)
    var = ((t1 - mu) ** 2).mean(-1, keepdim=True)
    y = (t1 - mu) * torch.rsqrt(var + 1e-6)
    y = F.gelu((y * lnw[0].float() + lnb[0].float()).to(dt))
    t2 = F.gelu((y.float() @ k2.float() + b2[0].float()).to(dt))   # (B, HW, 4, 4 * c8)
    g = t2.reshape(b, h * w, 16, c8)
    out = torch.einsum('bpkc,bmc->bpmk', g.float(), hyper_in.to(dt).float())
    out = out.reshape(b, h * w, m * 16).to(out_dtype)
    if active is not None:
        out = torch.where(active.bool()[:, None, None], out, torch.zeros_like(out))
    if blocked:
        return out.transpose(1, 2).contiguous()               # (B, M * 16, HW)
    return _interleave(out, b, h, w, m)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('upscale')
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.upscale_launch.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
        lib.upscale_launch.restype = ctypes.c_int
        lib.upscale_gelu_check.argtypes = [ptr] * 3
        lib.upscale_gelu_check.restype = ctypes.c_int
        lib.upscale_error_string.argtypes = [ctypes.c_int]
        lib.upscale_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active):
    dt = k1.dtype
    if dt not in (torch.float32, torch.bfloat16) or k2.dtype != dt:
        raise TypeError(f'upscale: k1 and k2 must both be float32 or bfloat16, '
                        f'got {k1.dtype} and {k2.dtype}')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'upscale: out_dtype must be float32 or bfloat16, got {out_dtype}')
    if src.ndim != 4 or hyper_in.ndim != 3 or hyper_in.shape[0] != src.shape[0]:
        raise ValueError(f'upscale: src must be (B, H, W, C) and hyper_in (B, M, C // 8), '
                         f'got {tuple(src.shape)} and {tuple(hyper_in.shape)}')
    c = src.shape[-1]
    c4, c8 = k1.shape[1] // 4, hyper_in.shape[-1]
    want = {'k1': (c, 4 * c4), 'b1': (1, 4 * c4), 'lnw': (1, c4), 'lnb': (1, c4),
            'k2': (c4, 4 * c8), 'b2': (1, 4 * c8)}
    for name, t in (('k1', k1), ('b1', b1), ('lnw', lnw), ('lnb', lnb), ('k2', k2),
                    ('b2', b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f'upscale: {name} must be {want[name]}, got {tuple(t.shape)}')
    if active is not None and tuple(active.shape) != (src.shape[0],):
        raise ValueError(f'upscale: active must be ({src.shape[0]},), '
                         f'got {tuple(active.shape)}')
    for name, t in (('hyper_in', hyper_in), ('k1', k1), ('b1', b1), ('lnw', lnw),
                    ('lnb', lnb), ('k2', k2), ('b2', b2), ('active', active)):
        if t is not None and t.device != src.device:
            raise ValueError(f'upscale: src on {src.device}, {name} on {t.device}')


def _launch(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active,
            blocked: bool) -> torch.Tensor:
    global launches
    lib = _library()
    b, h, w, c = src.shape
    m = hyper_in.shape[1]
    dt = k1.dtype
    if src.dtype != dt or not src.is_contiguous():
        raise ValueError(f'upscale: src must be contiguous and of the compute dtype '
                         f'{dt}, got {src.dtype} with strides {src.stride()}')
    if c != 256 or not 1 <= m <= 4:
        raise ValueError(f'upscale: the kernels are built for C = 256 channels and '
                         f'1 to 4 hypernetwork rows, got C = {c}, M = {m}')
    # small operands: cast and lay out as the kernel reads them
    hyper_in = hyper_in.to(dt).contiguous()
    k1, k2 = k1.contiguous(), k2.contiguous()
    b1, lnw, lnb, b2 = (t.float().contiguous() for t in (b1, lnw, lnb, b2))
    flags = None if active is None else active.to(torch.int32).contiguous()
    shape = (b, m * 16, h * w) if blocked else (b, h * w, m * 16)
    out = torch.empty(shape, dtype=out_dtype, device=src.device)
    if b == 0 or h * w == 0:   # nothing to launch, and nothing counted
        return out if blocked else _interleave(out, b, h, w, m)
    for t in (src, hyper_in, k1, k2):
        if t.data_ptr() % 16:
            raise ValueError('upscale: tensors must start on a 16-byte boundary')
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.upscale_launch(
            src.data_ptr(), hyper_in.data_ptr(), k1.data_ptr(), b1.data_ptr(),
            lnw.data_ptr(), lnb.data_ptr(), k2.data_ptr(), b2.data_ptr(),
            None if flags is None else flags.data_ptr(), out.data_ptr(),
            b, h * w, m, c, int(dt == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(blocked), stream)
    if err == _INVALID_VALUE:   # refused before anything was launched
        raise ValueError(f'upscale: the kernels refused B = {b}, HW = {h * w}, M = {m}')
    if err:
        raise RuntimeError('upscale kernel launch failed: '
                           + lib.upscale_error_string(err).decode())
    launches += 1
    return out if blocked else _interleave(out, b, h, w, m)


def _forward(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active, blocked):
    _check(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active)
    if src.device.type == 'cuda':
        return _launch(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active,
                       blocked)
    if src.device.type == 'cpu':
        return upscale_plain(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype,
                             active, blocked)
    raise ValueError(f'upscale: no kernel for device {src.device}')


class _Upscale(torch.autograd.Function):
    """Forward through the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, out_dtype, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.out_dtype = out_dtype
        return _forward(*tensors, out_dtype, None, False)

    @staticmethod
    def backward(ctx, grad):
        out_dtype = ctx.out_dtype
        return (None, *grad_through_plain(lambda *t: upscale_plain(*t, out_dtype),
                                          ctx.saved_tensors, ctx.needs_input_grad[1:],
                                          grad))


def upscale_hyper_masks(src, hyper_in, k1, b1, lnw, lnb, k2, b2,
                        out_dtype=torch.float32, active=None,
                        blocked: bool = False) -> torch.Tensor:
    """Fused mask head: src (B, H, W, C) and hyper_in (B, M, C // 8) -> masks
    (B, M, 4H, 4W) in `out_dtype`, or, with `blocked`, the candidate-major
    blocked masks (B, M * 16, HW) that `masks_from_blocked` interleaves.

    active: optional (B,) bool or int; a prompt whose flag is 0 skips the
    chain and gets zero masks (the everything-mode IoU gate). The gated and
    the blocked calls are inference-only; the plain call differentiates
    through `upscale_plain`."""
    with span('kernel.upscale'):
        if blocked or active is not None:
            return _forward(src, hyper_in, k1, b1, lnw, lnb, k2, b2, out_dtype, active,
                            blocked)
        return _Upscale.apply(out_dtype, src, hyper_in, k1, b1, lnw, lnb, k2, b2)


def gelu_table_check(device='cuda') -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's gelu on the card for all 65,536 bf16 bit patterns,
    beside the exact erf form evaluated there: (fast, exact), int16 tensors
    of the bf16 result bits, index = input bits. The kernel reads a table
    built from the exact form and takes the exact form outside it, so the
    two must be equal bit for bit."""
    lib = _library()
    fast = torch.empty(65536, dtype=torch.int16, device=device)
    exact = torch.empty_like(fast)
    with torch.cuda.device(fast.device):
        err = lib.upscale_gelu_check(fast.data_ptr(), exact.data_ptr(),
                                     torch.cuda.current_stream(fast.device).cuda_stream)
    if err:
        raise RuntimeError('upscale gelu check failed: ' + lib.upscale_error_string(err).decode())
    return fast, exact


def upscale_params_from_decoder(decoder, dtype: torch.dtype):
    """The mask head's weights of a `MaskDecoder`, flattened for the kernel:
    (k1, b1, lnw, lnb, k2, b2) with the transposed convs as (Cin, 4 * Cout)
    matrices in `dtype`, block order (dy, dx, f), and float32 biases tiled
    4x."""
    from regda_tpu_torch.models.sam.decoder import flatten_convt_weight
    convt1, ln, _, convt2, _ = decoder.output_upscaling
    return (flatten_convt_weight(convt1.weight, dtype),
            convt1.bias.float().repeat(4)[None],
            ln.weight.float()[None], ln.bias.float()[None],
            flatten_convt_weight(convt2.weight, dtype),
            convt2.bias.float().repeat(4)[None])
