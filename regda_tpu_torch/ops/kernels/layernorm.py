"""One-pass LayerNorm of the SAM ViT blocks: the CUDA kernel's wrapper and
its plain version.

Replaces the Pallas TPU kernel `layernorm`
(regda_tpu/models/sam/pallas_ln.py:64) with `csrc/layernorm.cu`; the kernel's
source note says what bounds it on the card and how it is laid out.

`layernorm` takes the kernel for CUDA tensors and `layernorm_plain` (the
counterpart of `pallas_ln._stock`) for CPU tensors; any other device raises.
There is no fallback: a CUDA input that the kernel cannot take raises.
`launches` counts kernel launches (plain-version calls do not count). The
gradient differentiates the plain version, as the JAX `custom_vjp` does: the
JAX package has no backward kernel either.
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._autograd import grad_through_plain
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `layernorm` in this process
launches = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with float32 two-pass moments; float32
    scale and bias; the result is rounded to x's dtype last."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('layernorm')
        lib.layernorm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        lib.layernorm_launch.restype = ctypes.c_int
        lib.layernorm_error_string.argtypes = [ctypes.c_int]
        lib.layernorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'layernorm: x must be float32 or bfloat16, got {x.dtype}')
    if x.ndim < 1:
        raise ValueError('layernorm: x needs a last axis to normalize over')
    c = x.shape[-1]
    for name, t in (('scale', scale), ('bias', bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f'layernorm: {name} must be float32 of shape ({c},), '
                             f'got {t.dtype} {tuple(t.shape)}')
        if t.device != x.device:
            raise ValueError(f'layernorm: x on {x.device}, {name} on {t.device}')


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    global launches
    lib = _library()
    c = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError('layernorm: x must be contiguous')
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    for t in (x, scale, bias, out):
        if t.data_ptr() % 16:
            raise ValueError('layernorm: tensors must start on a 16-byte boundary')
    rows = x.numel() // c
    if rows == 0:   # nothing to launch, and nothing counted
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.layernorm_launch(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, c, eps, int(x.dtype == torch.bfloat16), stream)
    if err == _INVALID_VALUE:   # refused before anything was launched
        raise ValueError(f'layernorm: the kernel is built for rows of 64, 768, 1024 '
                         f'or 1280 values (the ViT widths) and fewer than 2^34 '
                         f'rows, got {rows} rows of {c}')
    if err:
        raise RuntimeError('layernorm kernel launch failed: '
                           + lib.layernorm_error_string(err).decode())
    launches += 1
    return out


def _forward(x, scale, bias, eps):
    _check(x, scale, bias)
    if x.device.type == 'cuda':
        return _launch(x, scale, bias, eps)
    if x.device.type == 'cpu':
        return layernorm_plain(x, scale, bias, eps)
    raise ValueError(f'layernorm: no kernel for device {x.device}')


class _LayerNorm(torch.autograd.Function):
    """Forward through the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        eps = ctx.eps
        return (*grad_through_plain(lambda *t: layernorm_plain(*t, eps),
                                    ctx.saved_tensors, ctx.needs_input_grad[:3],
                                    grad), None)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape): float32
    moments, float32 `scale` and `bias` of shape (C,), output in x's dtype."""
    with span('kernel.layernorm'):
        return _LayerNorm.apply(x, scale, bias, eps)
