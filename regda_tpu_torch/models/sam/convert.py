"""JAX SAM variables -> the port's state_dict.

`sam_from_jax_variables` is the exact inverse of
regda_tpu/models/sam/convert.py:convert_sam_checkpoint: the Flax
`{'params': ...}` tree (numpy leaves) of a `Sam` becomes a state_dict under
segment-anything's key names, and `convert_sam_checkpoint` maps the result
back to the same tree bit for bit. Dense kernels transpose (in, out) ->
(out, in); convs go HWIO -> OIHW; transposed convs go (kh, kw, in, out) ->
(in, out, kh, kw) with the taps flipped back, because the Flax kernels hold
them flipped (lax.conv_transpose applies its kernel spatially flipped) while
the port applies `weight[:, :, dy, dx]` at offset (dy, dx) as torch does.

The result lacks what the tree lacks: `pixel_mean` and `pixel_std`, which are
constants of `Sam`. Load it with `load_jax_variables`.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _dense(arr):
    return arr.T


def _conv(arr):
    return arr.transpose(3, 2, 0, 1)


def _deconv(arr):
    return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _linear_or_norm(prefix: str, leaf: str, arr):
    """(kernel | scale | bias) of a Dense or LayerNorm -> torch key and value."""
    if leaf == 'kernel':
        return f'{prefix}.weight', _dense(arr)
    return f'{prefix}.{"weight" if leaf == "scale" else "bias"}', arr


def _encoder_key(path, arr):
    name = path[0]
    if name == 'patch_embed':
        return (('patch_embed.proj.weight', _conv(arr)) if path[1] == 'kernel'
                else ('patch_embed.proj.bias', arr))
    if name == 'pos_embed':
        return 'pos_embed', arr
    m = re.fullmatch(r'block(\d+)', name)
    if m:
        base, sub = f'blocks.{m.group(1)}', path[1]
        if sub in ('norm1', 'norm2'):
            return _linear_or_norm(f'{base}.{sub}', path[2], arr)
        if sub == 'attn':
            if path[2] in ('rel_pos_h', 'rel_pos_w'):
                return f'{base}.attn.{path[2]}', arr
            return _linear_or_norm(f'{base}.attn.{path[2]}', path[3], arr)
        if sub in ('mlp_lin1', 'mlp_lin2'):
            return _linear_or_norm(f'{base}.mlp.{sub[4:]}', path[2], arr)
    slot = {'neck_conv1': '0', 'neck_ln1': '1', 'neck_conv2': '2', 'neck_ln2': '3'}.get(name)
    if slot in ('0', '2'):
        return f'neck.{slot}.weight', _conv(arr)
    if slot in ('1', '3'):
        return f'neck.{slot}.{path[1]}', arr
    raise KeyError('/'.join(path))


def _prompt_key(path, arr):
    name = path[0]
    if name == 'pe_layer':
        return f'pe_layer.{path[1]}', arr
    m = re.fullmatch(r'point_embed_(\d)', name)
    if m:
        return f'point_embeddings.{m.group(1)}.weight', arr
    if name in ('not_a_point_embed', 'no_mask_embed'):
        return f'{name}.weight', arr
    raise KeyError('/'.join(path))


def _decoder_key(path, arr):
    name = path[0]
    if name == 'transformer':
        sub = path[1]
        m = re.fullmatch(r'layer(\d+)', sub)
        if m:
            base, part = f'transformer.layers.{m.group(1)}', path[2]
            if part.startswith('norm'):
                return _linear_or_norm(f'{base}.{part}', path[3], arr)
            if part in ('mlp_lin1', 'mlp_lin2'):
                return _linear_or_norm(f'{base}.mlp.{part[4:]}', path[3], arr)
            return _linear_or_norm(f'{base}.{part}.{path[3]}', path[4], arr)
        if sub == 'final_attn_token_to_image':
            return _linear_or_norm(f'transformer.{sub}.{path[2]}', path[3], arr)
        if sub == 'norm_final_attn':
            return _linear_or_norm(f'transformer.{sub}', path[2], arr)
    if name in ('iou_token', 'mask_tokens'):
        return f'{name}.weight', arr
    slot = {'upscale_conv1': '0', 'upscale_ln': '1', 'upscale_conv2': '3'}.get(name)
    if slot in ('0', '3'):
        return ((f'output_upscaling.{slot}.weight', _deconv(arr)) if path[1] == 'kernel'
                else (f'output_upscaling.{slot}.bias', arr))
    if slot == '1':
        return f'output_upscaling.1.{path[1]}', arr
    m = re.fullmatch(r'hyper_mlp(\d+)', name)
    if m:
        return _linear_or_norm(
            f'output_hypernetworks_mlps.{m.group(1)}.layers.{path[1][3:]}', path[2], arr)
    if name == 'iou_prediction_head':
        return _linear_or_norm(f'iou_prediction_head.layers.{path[1][3:]}', path[2], arr)
    raise KeyError('/'.join(path))


_MODULES = {'image_encoder': _encoder_key, 'prompt_encoder': _prompt_key,
            'mask_decoder': _decoder_key}


def sam_from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax `{'params': tree}` of a `Sam` (numpy or jax leaves) -> state_dict
    under segment-anything's names, as float32 torch tensors."""
    state = {}
    for path, arr in _leaves(variables['params']):
        key, value = _MODULES[path[0]](path[1:], arr)
        state[f'{path[0]}.{key}'] = torch.from_numpy(np.ascontiguousarray(value))
    return state


# What a segment-anything state_dict may hold or lack beyond the port's own
# keys, as the JAX converter (regda_tpu/models/sam/convert.py) allows: the
# mask-prompt branch of the prompt encoder, which the port does not have (it
# takes point prompts only), and the constants `pixel_mean` / `pixel_std`.
UNUSED_PREFIXES = ('prompt_encoder.mask_downscaling.',)
OPTIONAL_KEYS = frozenset({'pixel_mean', 'pixel_std'})


def load_sam_state_dict(model: torch.nn.Module, state: Mapping) -> None:
    """Load a segment-anything state_dict into the port's `Sam`, in place.
    Raises KeyError naming every key that is missing (beyond OPTIONAL_KEYS)
    or unexpected (beyond UNUSED_PREFIXES): a misnamed key would otherwise
    leave its parameter at its random initial value."""
    result = model.load_state_dict(state, strict=False)
    missing = sorted(set(result.missing_keys) - OPTIONAL_KEYS)
    unexpected = sorted(k for k in result.unexpected_keys if not k.startswith(UNUSED_PREFIXES))
    if missing or unexpected:
        raise KeyError(f'missing {missing}, unexpected {unexpected}')


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load a JAX `Sam`'s variables into the port's `Sam`, in place. Every
    parameter of the model must be covered; only the `pixel_mean` and
    `pixel_std` constants may be absent from the tree."""
    load_sam_state_dict(model, sam_from_jax_variables(variables))
