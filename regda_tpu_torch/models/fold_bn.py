"""Inference-time BatchNorm folding for the segmenter's eval forward
(counterpart of regda_tpu/models/fold_bn.py).

At eval, BatchNorm with running statistics is the per-channel affine
y = x * s + t with s = scale / sqrt(var + eps) and t = bias - mean * s. Every
BN of the model follows a bias-free conv, so s folds exactly into that
conv's output channels and only + t remains at run time: the folded model's
`FoldedBias`, which its conv adds in the convolution's epilogue
(models/resnet.py:conv_bias_act).

    folded = folded_model(model)             # same tree, BN -> FoldedBias,
                                             # carrying fold_batchnorm(model.state_dict())

The transform works on the port's state_dict, under the reference's key
names: a BN at `<m>.bnN` folds into `<m>.convN`, one at `<m>.<i>` of a
Sequential (`downsample.1`, `ppm.<i>.2`, `conv_last.1`) into `<m>.<i-1>`.
Training always uses the unfolded model.
"""

from __future__ import annotations

from typing import Mapping

import torch

from regda_tpu_torch.models.deeplabv2 import DeeplabV2

BN_EPS = 1e-5   # every BatchNorm of models/{resnet,heads}.py
_BN_LEAVES = ('weight', 'bias', 'running_mean', 'running_var', 'num_batches_tracked')


def _conv_of(bn: str) -> str:
    """The state_dict prefix of the conv that the BN at `bn` follows."""
    head, _, last = bn.rpartition('.')
    if last.startswith('bn'):
        return f'{head}.conv{last[2:]}'
    if last.isdigit() and int(last) > 0:
        return f'{head}.{int(last) - 1}'
    raise ValueError(f'BatchNorm {bn!r} has no conv before it to fold into')


def fold_batchnorm(state: Mapping[str, torch.Tensor],
                   eps: float = BN_EPS) -> dict[str, torch.Tensor]:
    """Fold every BatchNorm's eval affine into the conv before it.

    Returns the state_dict of the `folded=True` model: each conv weight that
    a BN follows is scaled along its output channels by s (computed in
    float32, cast back to the weight's dtype), and the BN's entries become
    one `bias`, t. A state_dict without running statistics (already folded)
    comes back unchanged."""
    out = dict(state)
    for key in state:
        if not key.endswith('.running_mean'):
            continue
        bn = key[:-len('.running_mean')]
        wkey = f'{_conv_of(bn)}.weight'
        if wkey not in state:
            raise ValueError(f'BatchNorm {bn!r}: no conv weight {wkey!r} to fold into')
        s = state[f'{bn}.weight'].float() / torch.sqrt(state[f'{bn}.running_var'].float() + eps)
        t = state[f'{bn}.bias'].float() - state[f'{bn}.running_mean'].float() * s
        w = state[wkey]
        out[wkey] = (w.float() * s.view(-1, *([1] * (w.dim() - 1)))).to(w.dtype)
        for leaf in _BN_LEAVES:
            out.pop(f'{bn}.{leaf}', None)
        out[f'{bn}.bias'] = t
    return out


def folded_model(model: DeeplabV2) -> DeeplabV2:
    """A `folded=True` copy of `model` in eval mode, on its device and in
    its memory format, at its output stride, carrying
    `fold_batchnorm(model.state_dict())`."""
    folded = DeeplabV2(model.resnet_type, model.num_classes, model.multi_layer,
                       model.use_ppm, model.is_ins_norm, model.fc_dim, folded=True,
                       dtype=model.dtype, output_stride=model.output_stride)
    stem = model.encoder.resnet.conv1.weight
    fmt = (torch.channels_last if stem.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    folded = folded.to(stem.device, memory_format=fmt)
    folded.load_state_dict(fold_batchnorm(model.state_dict()))
    return folded.eval()
