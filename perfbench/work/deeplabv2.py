"""Operations of the `deeplabv2` configurations, from their shapes alone.

A convolution's forward is 2 x Cin x Cout x k^2 x Hout x Wout operations
(a multiply and an add each); its backward is the same again for the
gradient of its weights and once more for that of its input, which the
stem, whose input is the image, does not need. Matrix products count
2 x M x N x K. Elementwise work, pooling, resizes and softmaxes are left
out: they are no share of the tensor or FMA peak a step can reach.
"""

from __future__ import annotations

import math

DEPTHS = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3),
          'resnet50': (3, 4, 6, 3), 'resnet101': (3, 4, 23, 3)}
BASIC = ('resnet18', 'resnet34')
STRIDES_OS16 = (1, 2, 2, 1)


def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    return 2 * cin * cout * k * k * hout * wout


def _out(n: int, stride: int) -> int:
    return math.ceil(n / stride)


def encoder_flops(backbone: str, h: int, w: int) -> tuple[int, int]:
    """(all convolutions, the stem's) of one image's encoder forward at OS 16."""
    h, w = _out(h, 2), _out(w, 2)
    stem = conv_flops(3, 64, 7, h, w)
    h, w = _out(h, 2), _out(w, 2)                   # the max pool
    total, cin, planes = stem, 64, 64
    basic = backbone in BASIC
    expansion = 1 if basic else 4
    for n, stride in zip(DEPTHS[backbone], STRIDES_OS16):
        for b in range(n):
            s = stride if b == 0 else 1
            ho, wo = _out(h, s), _out(w, s)
            if basic:
                total += conv_flops(cin, planes, 3, ho, wo) + conv_flops(planes, planes, 3, ho, wo)
            else:
                total += (conv_flops(cin, planes, 1, h, w) + conv_flops(planes, planes, 3, ho, wo)
                          + conv_flops(planes, planes * 4, 1, ho, wo))
            if b == 0 and (s != 1 or cin != planes * expansion):
                total += conv_flops(cin, planes * expansion, 1, ho, wo)
            cin, h, w = planes * expansion, ho, wo
        planes *= 2
    return total, stem


def feature_size(h: int, w: int) -> tuple[int, int]:
    return _out(h, 16), _out(w, 16)


def head_flops(model: dict, h: int, w: int) -> int:
    """One PPM head's forward on one image of h x w pixels."""
    fh, fw = feature_size(h, w)
    fc, width, scales = model['fc_dim'], model['ppm_dim'], model['ppm_scales']
    pools = sum(conv_flops(fc, width, 1, s, s) for s in scales)
    last = conv_flops(fc + len(scales) * width, width, 3, fh, fw)
    return pools + last + conv_flops(width, model['num_classes'], 1, fh, fw)


def forward_flops(model: dict, h: int, w: int) -> int:
    """One image through the encoder and both heads."""
    return encoder_flops(model['backbone'], h, w)[0] + 2 * head_flops(model, h, w)


def stage2_step_flops(model: dict, batch: int, h: int, w: int) -> int:
    """One stage-2 step on `batch` source and `batch` target crops: both
    forwards; the backward of the source through the heads and the encoder
    and of the target through the encoder alone (its heads feed only the
    pseudo-labels, which carry no gradient); and Deep CORAL's two (K, K)
    covariances of the feature rows, each a product forward and one back.
    The prototype terms, (rows x K) by (K x C), are left out."""
    enc, stem = encoder_flops(model['backbone'], h, w)
    heads = 2 * head_flops(model, h, w)
    per_image = (enc + heads) * 2 + (2 * enc - stem + 2 * heads) + (2 * enc - stem)
    fh, fw = feature_size(h, w)
    rows, k = batch * fh * fw, model['fc_dim']
    return batch * per_image + 2 * 2 * (2 * rows * k * k)


def eval_tile_flops(model: dict, tile: int, views: int = 8) -> int:
    """One tile of `tile` x `tile` through the 8 dihedral views."""
    return views * forward_flops(model, tile, tile)
