"""JAX variables -> the port's state_dict, and a checked state_dict load.

`from_jax_variables` is the inverse of
regda_tpu/utils/torch_convert.py:torch_state_dict_to_variables: the Flax
`{'params', 'batch_stats'}` tree (numpy leaves) of a DeeplabV2 becomes a
state_dict under the reference's key names, with conv kernels HWIO -> OIHW,
BN `scale/bias` -> `weight/bias`, `mean/var` -> `running_mean/running_var`.
`torch_state_dict_to_variables` maps the result back to the same tree
exactly. It also carries a DeeplabV2MMD's tree (its `reduction_layer`'s
dense kernels (in, out) -> (out, in)).

`from_flax_variables` does the same for the periphery models, whose port
modules carry the JAX package's module names: TransNorm (`scale/bias` ->
`weight/bias`, its per-domain statistics under their own names), the
discriminators, and SpixelNet (`spixelnet_from_jax`, which names Flax's
`_ConvBlock_<i>/{Conv_0, BatchNorm_0}` as the port's `conv<k>{a,b}.{conv, bn}`).

`load_segmenter_state_dict` loads a reference-layout state_dict (a `.pth`
that the reference, the port or the JAX package's converter reads) into the
port's DeeplabV2 and refuses any key that is missing or left over.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch

from regda_tpu_torch.models.spixelnet import BLOCKS

_HEAD_SLOTS = {'conv_last_conv': 'conv_last.0', 'conv_last_bn': 'conv_last.1',
               'conv_last_out': 'conv_last.4'}
_LEAVES = {('params', 'kernel'): 'weight', ('params', 'scale'): 'weight',
           ('params', 'bias'): 'bias', ('batch_stats', 'mean'): 'running_mean',
           ('batch_stats', 'var'): 'running_var'}


def _module_key(path: tuple[str, ...]) -> str:
    """Flax module path -> reference state_dict prefix."""
    top, rest = path[0], path[1:]
    if top == 'reduction_layer':
        return '.'.join(path)
    if top == 'encoder':
        if rest[0] in ('conv1', 'bn1'):
            return f'encoder.resnet.{rest[0]}'
        m = re.fullmatch(r'layer(\d)_(\d+)', rest[0])
        if m is None:
            raise KeyError('/'.join(path))
        sub = {'downsample_conv': 'downsample.0',
               'downsample_bn': 'downsample.1'}.get(rest[1], rest[1])
        return f'encoder.resnet.layer{m.group(1)}.{m.group(2)}.{sub}'
    if top in ('layer5', 'layer6', 'cls_pred'):
        name = rest[0]
        m = re.fullmatch(r'ppm_(\d+)_(conv|bn)', name)
        if m:
            return f'{top}.ppm.{m.group(1)}.{1 if m.group(2) == "conv" else 2}'
        m = re.fullmatch(r'aspp_(\d+)', name)
        if m:
            return f'{top}.conv2d_list.{m.group(1)}'
        if name in _HEAD_SLOTS:
            return f'{top}.{_HEAD_SLOTS[name]}'
    raise KeyError('/'.join(path))


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax_variables(variables: Mapping,
                        module_key: Callable[[tuple], str] = '.'.join) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} numpy tree -> port state_dict,
    each module path named by `module_key`: conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in), the leaves renamed by _LEAVES (other
    statistics keep their names)."""
    state = {}
    for coll in ('params', 'batch_stats'):
        for path, arr in _leaves(variables.get(coll, {})):
            arr = np.asarray(arr, dtype=np.float32)
            if path[-1] == 'kernel':
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            prefix = module_key(path[:-1])
            leaf = _LEAVES.get((coll, path[-1]), path[-1])
            state[f'{prefix}.{leaf}' if prefix else leaf] = torch.from_numpy(
                np.array(arr, order='C'))  # own copy
    return state


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """A DeeplabV2's (or DeeplabV2MMD's) numpy tree -> port state_dict."""
    return from_flax_variables(variables, _module_key)


def _spixel_key(path: tuple[str, ...]) -> str:
    parts = []
    for name in path:
        m = re.fullmatch(r'_ConvBlock_(\d+)', name)
        parts.append(BLOCKS[int(m.group(1))] if m else
                     {'Conv_0': 'conv', 'BatchNorm_0': 'bn'}.get(name, name))
    return '.'.join(parts)


def spixelnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """A SpixelNet's numpy tree -> port state_dict."""
    return from_flax_variables(variables, _spixel_key)


# keys of a reference torch checkpoint that carry nothing for the model, as
# the JAX package's converter skips them (regda_tpu/utils/torch_convert.py)
UNUSED_SUFFIXES = ('.num_batches_tracked',)
UNUSED_PREFIXES = ('instance_norm',)


def load_segmenter_state_dict(model: torch.nn.Module, state: Mapping) -> None:
    """Load a reference-layout DeepLabv2 state_dict into the port's model, in
    place. Raises KeyError naming every key that is missing, or present and
    unknown to the model (beyond UNUSED_*): a misnamed key would otherwise
    leave its parameter at its random initial value."""
    state = {k: v for k, v in state.items()
             if not (k.endswith(UNUSED_SUFFIXES) or k.startswith(UNUSED_PREFIXES))}
    result = model.load_state_dict(state, strict=False)
    if result.missing_keys or result.unexpected_keys:
        raise KeyError(f'missing {sorted(result.missing_keys)}, '
                       f'unexpected {sorted(result.unexpected_keys)}')
