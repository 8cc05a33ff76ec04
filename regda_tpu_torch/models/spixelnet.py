"""SpixelNet: a CNN superpixel network with alternating horizontal and
vertical transposed convolutions (counterpart of regda_tpu/models/
spixelnet.py).

Reference: regda/gast/sin/spixel_deconv.py:13-121 (`SpixelNet`) and
sin/model_util.py:12-62, which the reference's active path never imports.
A five-stage stride-2 encoder (16 to 256 channels, LeakyReLU 0.1, BatchNorm
by default) and a decoder that doubles the width, then the height, at each
level, with a softmaxed 2-way assignment after every half step, returned
fine to coarse: (prob0_v, prob0_h, prob1_v, prob1_h, prob2_v, prob2_h,
prob3_v, prob3_h), level k at stride 2^k of the input.

The JAX package's documented deviation is kept: the reference's
ConvTranspose2d(k=3, s=2, p=1) gives odd (2n - 1) sizes; here each
transposed conv gives exactly 2x (or 1x2, 2x1), as Flax's ConvTranspose
with 'SAME' padding does (`_conv_transpose_same`). Convolutions pad as
XLA's 'SAME' (at stride 2 on an even size: none before, one after). NHWC
in and out.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from regda_tpu_torch.models.resnet import BatchNorm2d

BLOCKS = ('conv0a', 'conv0b', 'conv1a', 'conv1b', 'conv2a', 'conv2b', 'conv3a', 'conv3b',
          'conv4a', 'conv4b')


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv (no padding of its own) with XLA's 'SAME' padding, NCHW."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = _same_pads(x.shape[2], kh, sh)
    left, right = _same_pads(x.shape[3], kw, sw)
    return conv(F.pad(x, (left, right, top, bottom)))


def _transpose_pads(k: int, s: int) -> tuple[int, int]:
    """lax.conv_transpose's 'SAME' padding of the stride-dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


def _conv_transpose_same(x: torch.Tensor, conv: nn.Conv2d, stride: tuple[int, int]):
    """Flax ConvTranspose(padding='SAME') with `conv`'s kernel, unflipped:
    the input dilated by the stride, padded, and correlated, NCHW; the
    output is the input's size times the stride."""
    sh, sw = stride
    b, c, h, w = x.shape
    dil = x.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
    dil[:, :, ::sh, ::sw] = x
    kh, kw = conv.kernel_size
    top, bottom = _transpose_pads(kh, sh)
    left, right = _transpose_pads(kw, sw)
    return conv(F.pad(dil, (left, right, top, bottom)))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, use_bn: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, bias=not use_bn)
        self.bn = BatchNorm2d(cout) if use_bn else None

    def forward(self, x):
        x = conv_same(x, self.conv)
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, 0.1)


class SpixelNet(nn.Module):
    def __init__(self, use_bn: bool = True, in_channels: int = 3):
        super().__init__()
        widths = (16, 16, 32, 32, 64, 64, 128, 128, 256, 256)
        cin = in_channels
        for name, cout in zip(BLOCKS, widths):
            stride = 2 if name.endswith('a') and name != 'conv0a' else 1
            setattr(self, name, ConvBlock(cin, cout, stride, use_bn))
            cin = cout
        for lvl, f in zip((3, 2, 1, 0), (128, 64, 32, 16)):
            for d in ('h', 'v'):
                setattr(self, f'deconv{lvl}_{d}', nn.Conv2d(cin, f, 3))
                setattr(self, f'pred_mask{lvl}_{d}', nn.Conv2d(f, 2, 3))
                cin = f

    def forward(self, x: torch.Tensor):
        """x (B, H, W, C), H and W multiples of 16 -> 8 (B, h, w, 2)
        softmaxed maps, fine to coarse (module docstring)."""
        out = x.permute(0, 3, 1, 2)
        for name in BLOCKS:
            out = getattr(self, name)(out)
        probs = {}
        for lvl in (3, 2, 1, 0):
            for d, stride in (('h', (1, 2)), ('v', (2, 1))):
                out = F.leaky_relu(_conv_transpose_same(
                    out, getattr(self, f'deconv{lvl}_{d}'), stride), 0.1)
                mask = conv_same(out, getattr(self, f'pred_mask{lvl}_{d}'))
                probs[f'{lvl}{d}'] = torch.softmax(mask, dim=1).permute(0, 2, 3, 1)
        return tuple(probs[k] for k in ('0v', '0h', '1v', '1h', '2v', '2h', '3v', '3h'))
