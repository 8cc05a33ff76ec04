"""Fused dual-head PPM eval forward of the deployed inference graph
(counterpart of regda_tpu/models/fused_eval.py).

Both PPM heads' 3x3 `conv_last` read the same fc-channel feature half of
their concatenated input (regda/models/Encoder.py:40-46), and a conv over a
concatenation splits exactly into convs over its parts:

    conv(cat[feat, pools_i], k_i) = conv(feat, k_i[:, :fc]) + conv(pools_i, k_i[:, fc:])

so the feature half of both heads runs as ONE conv of 2 x 512 output
channels, and each head adds its own conv over its pooled pyramid. The two
heads also share the adaptive pools of the feature map, which only their
branches' 1x1 convs tell apart. The same work regrouped; it equals the
stock forward to rounding.

It covers the deployed configuration: two PPM heads on a folded model.
`eval_forward` falls back to the model's own forward for anything else.
Whether to take it is the caller's decision (infer.py reads
REGDA_NO_FUSED_PPM once, when it builds its inferencer), not this module's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from regda_tpu_torch.models.deeplabv2 import DeeplabV2, dual_head_probs
from regda_tpu_torch.models.resnet import conv_bias_act


def supports_fused_heads(model: DeeplabV2) -> bool:
    """Dual PPM heads on a folded (inference) DeeplabV2."""
    return model.folded and model.multi_layer and model.use_ppm


def fused_dual_ppm_eval(model: DeeplabV2, x: torch.Tensor) -> torch.Tensor:
    """Eval forward of a model that `supports_fused_heads`: x (B, H, W, 3)
    -> (B, H, W, C) probabilities, as `model(x)` in eval mode."""
    feat = model.features(x)
    fc = feat.shape[1]
    heads = (model.layer5, model.layer6)
    pooled = heads[0].pooled(feat)   # both heads pool the same map at the same scales
    kernels = [h.conv_last[0].weight for h in heads]
    shared = F.conv2d(feat, torch.cat([k[:, :fc] for k in kernels]).to(feat.dtype), padding=1)
    preds = []
    for i, (head, kernel) in enumerate(zip(heads, kernels)):
        _, bias, _, _, classifier = head.conv_last
        half = kernel.shape[0]
        y = conv_bias_act(torch.cat(head.pools(feat, pooled), dim=1), kernel[:, fc:], bias.bias,
                          padding=(1, 1), relu=True,
                          residual=shared[:, i * half:(i + 1) * half])
        preds.append(classifier(y))
    return dual_head_probs(*preds, tuple(x.shape[1:3]))


def eval_forward(model: DeeplabV2, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """The deployed eval forward: the fused dual-head path where `fused` and
    the model supports it, else the model's own."""
    if fused and supports_fused_heads(model):
        return fused_dual_ppm_eval(model, x)
    return model(x)
