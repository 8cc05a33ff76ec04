"""SAM ViT attention with the decomposed relative-position bias fused in: the
CUDA kernels' wrapper and the plain version.

Replaces the Pallas TPU kernel `attention_with_rel_bias`
(regda_tpu/models/sam/pallas_attention.py:136) with `csrc/rel_attention.cu`;
the source note there says what bounds it on the card and how the two kernels
(bfloat16 on the tensor cores, float32 on the ordinary units) are laid out.

`rel_attention` takes the kernel for CUDA tensors and `rel_attention_plain`
(the counterpart of `pallas_attention._attn_stock`) for CPU tensors; any
other device raises. There is no fallback: a CUDA input that the kernel
cannot take raises. `launches` counts kernel launches (plain-version calls do
not count). The gradient differentiates the plain version, as the JAX
`custom_vjp` does: the JAX package has no backward kernel either.

Layouts are the JAX package's: qkv (3, B, H, N, D) with N = kh * kw tokens in
row-major (h, w) order, rh (B, H, N, kh), rw (B, H, N, kw), result
(B, H, N, D) in qkv's dtype. The kernel reads q, k and v through qkv's
strides, so the permuted view of the qkv projection's (B, N, 3 * H * D)
output is taken without a copy; only the head dim must be contiguous. The
kernel writes its result in (B, N, H, D) order and returns the (B, H, N, D)
view of it, so merging the heads afterwards is a reshape, not a transpose.
rh and rw are cast to qkv's dtype and made contiguous if they are not.
"""

from __future__ import annotations

import ctypes

import torch

from regda_tpu_torch.ops.kernels import _build
from regda_tpu_torch.ops.kernels._autograd import grad_through_plain
from regda_tpu_torch.utils.profiling import span

# kernel launches made by `rel_attention` in this process
launches = 0

_lib = None
_INVALID_VALUE = 1   # cudaErrorInvalidValue


def rel_attention_plain(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor,
                        scale: float, kh: int, kw: int) -> torch.Tensor:
    """softmax((q * scale) @ k^T + rh[q, k // kw] + rw[q, k % kw]) @ v with the
    kernel's rounding points: q * scale in float32 then rounded to qkv's
    dtype, rh and rw in qkv's dtype, float32 logits and softmax, the
    probabilities rounded to qkv's dtype before the product with v, float32
    accumulation, and the division by the softmax sum last. Products of
    rounded values are taken in float32, which is exact for bfloat16."""
    dt = qkv.dtype
    q, k, v = qkv[0], qkv[1], qkv[2]
    b, h, n, _ = q.shape
    qs = (q.float() * scale).to(dt).float()
    logits = qs @ k.float().transpose(-1, -2)                  # (B, H, N, N)
    logits = logits.view(b, h, n, kh, kw)
    logits = logits + rh.to(dt).float()[..., :, None]
    logits = logits + rw.to(dt).float()[..., None, :]
    logits = logits.view(b, h, n, n)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = p.sum(-1, keepdim=True)
    out = p.to(dt).float() @ v.float()
    return (out / s).to(dt)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library('rel_attention')
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.rel_attention_launch.argtypes = [
            ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, i64, i64, i64,
            i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.rel_attention_launch.restype = ctypes.c_int
        lib.rel_attention_error_string.argtypes = [ctypes.c_int]
        lib.rel_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, kh: int, kw: int):
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'rel_attention: qkv must be float32 or bfloat16, got {qkv.dtype}')
    if qkv.ndim != 5 or qkv.shape[0] != 3:
        raise ValueError(f'rel_attention: qkv must be (3, B, H, N, D), got {tuple(qkv.shape)}')
    _, b, h, n, _ = qkv.shape
    if n != kh * kw:
        raise ValueError(f'rel_attention: N = {n} tokens but kh * kw = {kh * kw}')
    if tuple(rh.shape) != (b, h, n, kh) or tuple(rw.shape) != (b, h, n, kw):
        raise ValueError(f'rel_attention: rh and rw must be {(b, h, n, kh)} and '
                         f'{(b, h, n, kw)}, got {tuple(rh.shape)} and {tuple(rw.shape)}')
    if rh.device != qkv.device or rw.device != qkv.device:
        raise ValueError(f'rel_attention: qkv on {qkv.device}, rh on {rh.device}, '
                         f'rw on {rw.device}')


def _launch(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, scale: float,
            kh: int, kw: int) -> torch.Tensor:
    global launches
    lib = _library()
    _, b, h, n, d = qkv.shape
    if b * h > 65535 or max(kh, kw) > 32767:
        raise ValueError(f'rel_attention: B * H = {b * h} must be at most 65535 and '
                         f'kh, kw = {kh}, {kw} below 32768')
    vec = 16 // qkv.element_size()   # elements in a 16-byte load
    s3, sb, sh, sn, sd = qkv.stride()
    if sd != 1 or any(s % vec for s in (s3, sb, sh, sn)) or qkv.data_ptr() % 16:
        raise ValueError(
            f'rel_attention: qkv must have a contiguous head dim and rows on '
            f'16-byte boundaries; got strides {qkv.stride()} at offset '
            f'{qkv.data_ptr() % 16} (call .contiguous() first)')
    rh = rh.to(qkv.dtype).contiguous()
    rw = rw.to(qkv.dtype).contiguous()
    out = torch.empty((b, n, h, d), dtype=qkv.dtype, device=qkv.device).permute(0, 2, 1, 3)
    if out.numel() == 0:   # nothing to launch, and nothing counted
        return out
    ob, oh, on, _ = out.stride()
    step = s3 * qkv.element_size()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.rel_attention_launch(
            qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step,
            sb, sh, sn, rh.data_ptr(), rw.data_ptr(), out.data_ptr(), ob, oh, on,
            b, h, n, d, kh, kw, scale, int(qkv.dtype == torch.bfloat16), stream)
    if err == _INVALID_VALUE:   # refused before anything was launched
        raise ValueError(f'rel_attention: the kernels are built for head dims 32, 64 '
                         f'and 80 (the ViT configurations) and bias tables that fit '
                         f'a block\'s shared memory, got D = {d}, kh, kw = {kh}, {kw}')
    if err:
        raise RuntimeError('rel_attention kernel launch failed: '
                           + lib.rel_attention_error_string(err).decode())
    launches += 1
    return out


def _forward(qkv, rh, rw, scale, kh, kw):
    _check(qkv, rh, rw, kh, kw)
    if qkv.device.type == 'cuda':
        return _launch(qkv, rh, rw, scale, kh, kw)
    if qkv.device.type == 'cpu':
        return rel_attention_plain(qkv, rh, rw, scale, kh, kw)
    raise ValueError(f'rel_attention: no kernel for device {qkv.device}')


class _RelAttention(torch.autograd.Function):
    """Forward through the kernel; backward through the plain version."""

    @staticmethod
    def forward(ctx, qkv, rh, rw, scale, kh, kw):
        ctx.save_for_backward(qkv, rh, rw)
        ctx.consts = (scale, kh, kw)
        return _forward(qkv, rh, rw, scale, kh, kw)

    @staticmethod
    def backward(ctx, grad):
        consts = ctx.consts
        return (*grad_through_plain(lambda *t: rel_attention_plain(*t, *consts),
                                    ctx.saved_tensors, ctx.needs_input_grad[:3],
                                    grad), None, None, None)


def rel_attention(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, *,
                  scale: float, kh: int, kw: int) -> torch.Tensor:
    """Attention over N = kh * kw tokens with the decomposed rel-pos bias:
    qkv (3, B, H, N, D), rh (B, H, N, kh), rw (B, H, N, kw) -> (B, H, N, D)
    in qkv's dtype (see the module docstring for layouts and strides)."""
    with span('kernel.rel_attention'):
        return _RelAttention.apply(qkv, rh, rw, scale, kh, kw)
