"""SAM image encoder (counterpart of regda_tpu/models/sam/vit.py): a ViT with
14x14 window attention except at the global-attention blocks, per-axis
decomposed relative-position biases, and a conv neck to 256 channels.

Images, activations and embeddings are NHWC, as in the JAX package.
Parameter names are segment-anything's (`blocks.N.attn.qkv.weight`,
`neck.0.weight`, ...), so `state_dict()` has an official checkpoint's keys.
Parameters stay float32; `dtype` is the compute dtype: every `Linear` and
conv casts its input and its parameters to it (as a Flax layer with
`dtype=` does), and the residual stream stays in it. The cast of the
parameters happens at every call; no bfloat16 copy is cached.

The two hand-written kernels sit where the JAX package has its Pallas
kernels: `BlockNorm` (ops/kernels/layernorm.py) and the attention core of
`Attention` (ops/kernels/rel_attention.py). Each takes its CUDA kernel on a
CUDA tensor and its plain version on a CPU tensor. Everything else is stock
PyTorch. Windowed blocks use the per-block partition/unpartition form, the
JAX package's default.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from regda_tpu_torch.ops.kernels.layernorm import layernorm
from regda_tpu_torch.ops.kernels.rel_attention import rel_attention

VIT_CONFIGS = {
    # tiny config for tests / smoke runs
    'vit_t': dict(embed_dim=64, depth=2, num_heads=2,
                  global_attn_indexes=(1,)),
    'vit_b': dict(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11)),
    'vit_l': dict(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23)),
    'vit_h': dict(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31)),
}


class Linear(nn.Linear):
    """nn.Linear that computes in `dtype`: input and float32 parameters are
    cast to it. `dtype=None` computes in float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over the last axis of NHWC maps, computed in
    the input's dtype; the float32 affine promotes the result to float32."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of the JAX package's table resize: linear
    interpolation at half-pixel centres with a triangle filter widened by the
    shrink factor (antialiasing) when out_size < in_size."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Resize the relative-position table to 2 * max(q, k) - 1 rows if it has
    another length, then gather it to (q_size, k_size, head_dim). The resize
    is the JAX package's (antialiased when shrinking), which differs from
    segment-anything's plain linear interpolation for a longer table; the
    published checkpoints need no resize at their own image size."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        mat = torch.from_numpy(_linear_resize_matrix(rel_pos.shape[0], max_rel_dist))
        table = mat.t().to(rel_pos.device) @ rel_pos.float()
    else:
        table = rel_pos
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return table[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


class Attention(nn.Module):
    """Multi-head attention over an (h, w) token grid with decomposed rel-pos
    bias. The q-contracted bias tables come from two stock einsums (float32
    accumulation, rounded to the compute dtype); logits, softmax and the
    product with v are the `rel_attention` kernel."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        b, h, w, dim = x.shape
        heads, head_dim = self.num_heads, dim // self.num_heads
        # one permuted view (3, B, H, N, D) of the projection's output; the
        # kernel reads q, k and v through its strides
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        rh = _get_rel_pos(h, h, self.rel_pos_h)            # (h, h, hd)
        rw = _get_rel_pos(w, w, self.rel_pos_w)
        r_q = qkv[0].reshape(b, heads, h, w, head_dim).float()
        rel_h = torch.einsum('bgxyc,xkc->bgxyk', r_q, rh.float()).to(qkv.dtype)
        rel_w = torch.einsum('bgxyc,ykc->bgxyk', r_q, rw.float()).to(qkv.dtype)
        out = rel_attention(qkv, rel_h.reshape(b, heads, h * w, h),
                            rel_w.reshape(b, heads, h * w, w),
                            scale=self.scale, kh=h, kw=w)  # (B, H, N, D)
        out = out.transpose(1, 2).reshape(b, h, w, dim)
        return self.proj(out)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as reshape + one GEMM. The parameters
    are those of segment-anything's 16x16/stride-16 conv (`proj.weight` is
    OIHW); each patch is flattened in (py, px, c) order and multiplied with
    the weight permuted to match, which is the same arithmetic."""

    def __init__(self, embed_dim: int, patch: int = 16, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch, patch)

    def forward(self, x):
        n, h, w, c = x.shape
        p, dt = self.patch, self.dtype
        gh, gw = h // p, w // p
        xp = (x.to(dt).reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
              .reshape(n, gh, gw, p * p * c))
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, p * p * c)
        return F.linear(xp, weight.to(dt), self.proj.bias.to(dt))


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> ((B * windows, window, window, C), padded (H, W)); the
    bottom and right are padded with zeros up to whole windows."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    win = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return win, (hp, wp)


def window_unpartition(win: torch.Tensor, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // window // window)
    x = win.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class BlockNorm(nn.Module):
    """LayerNorm over channels through the one-pass kernel
    (ops/kernels/layernorm.py); parameters as `nn.LayerNorm`'s."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layernorm(x.contiguous(), self.weight, self.bias, self.eps)


class MLPBlock(nn.Module):
    """lin2(act(lin1(x))); the encoder's activation is the exact (erf) gelu."""

    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype, act=F.gelu):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim, dtype=dtype)
        self.lin2 = Linear(mlp_dim, dim, dtype=dtype)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """Pre-norm transformer block; `window_size` 0 means global attention.
    Windows are cut from the normalized tensor, so the zero padding joins the
    windowed softmax as zero tokens."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 input_size: tuple[int, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.norm1 = BlockNorm(dim)
        self.attn = Attention(
            dim, num_heads, dtype=dtype,
            input_size=(window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = BlockNorm(dim)
        self.mlp = MLPBlock(dim, dim * 4, dtype)

    def forward(self, x):
        ws = self.window_size
        shortcut = x
        y = self.norm1(x)
        if ws > 0:
            hw = y.shape[1:3]
            y, pad_hw = window_partition(y, ws)
        y = self.attn(y)
        if ws > 0:
            y = window_unpartition(y, ws, pad_hw, hw)
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads,
                  window_size=0 if i in global_attn_indexes else window_size,
                  input_size=(grid, grid), dtype=dtype)
            for i in range(depth)])
        # upstream's neck: 1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x):
        """x: (B, img_size, img_size, 3) preprocessed -> (B, grid, grid, 256)."""
        dt = self.dtype
        # the residual stream stays in the compute dtype
        x = self.patch_embed(x) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        conv1, ln1, conv2, ln2 = self.neck
        x = ln1(F.linear(x, conv1.weight.to(dt).flatten(1)))    # the 1x1 conv
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv2.weight.to(dt), padding=1)
        return ln2(x.permute(0, 2, 3, 1))
