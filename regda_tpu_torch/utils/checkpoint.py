"""Checkpoints of the port: torch `.pth` files under the reference's key names
(counterpart of regda_tpu/utils/checkpoint.py).

The reference torch.save's state_dicts with `_curr` / `_best` names
(tools/train_src.py:151-158); the port keeps the names and the format, so
the reference, the port and the JAX package's `load_pytree` (through
regda_tpu/utils/torch_convert.py) all read what it writes. The JAX package's
own checkpoints are Orbax directories, which the port does not read: a
directory is refused with an error that says so. Every write goes to a
temporary file renamed into place, so a crash mid-write never leaves a
truncated checkpoint under the final name.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Mapping

import numpy as np
import torch

from regda_tpu_torch.utils.convert import load_segmenter_state_dict


def save_state_dict(path: str, obj: Any) -> None:
    """torch.save `obj` (a state_dict, a train state, a bare tensor) to
    `path` atomically: a temporary file beside it, then os.replace."""
    path = os.path.abspath(os.path.expanduser(path))
    fd, tmp = tempfile.mkstemp(suffix='.tmp', dir=os.path.dirname(path) or '.')
    try:
        with os.fdopen(fd, 'wb') as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_state_dict(path: str) -> Any:
    """torch.load a `.pth` (a state_dict, a train state, a bare tensor) onto
    the CPU, tensors, dicts, lists and numbers only. A directory (the JAX
    package's Orbax checkpoint) raises."""
    path = os.path.abspath(os.path.expanduser(path))
    if os.path.isdir(path):
        raise ValueError(f'{path} is a directory (an Orbax checkpoint of the JAX package '
                         'regda_tpu?); the port reads a .pth state_dict under the '
                         'reference key names')
    return torch.load(path, map_location='cpu', weights_only=True)


def to_host(tree: Any) -> Any:
    """A copy of `tree` (nested dicts, lists and tuples) with every tensor
    copied to host memory, so that later in-place updates of the originals
    (the train step's) do not reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a `.pth` state_dict into `model` (KeyError on a missing or
    unexpected key; ValueError on a directory)."""
    load_segmenter_state_dict(model, load_state_dict(path))


def save_prototypes(path: str, prototypes) -> None:
    """Prototype matrices are small; store as .npy (the reference stores a
    bare tensor .pth, tools/init_prototypes.py:112)."""
    if isinstance(prototypes, torch.Tensor):
        prototypes = prototypes.detach().cpu().numpy()
    np.save(path if path.endswith('.npy') else path + '.npy', np.asarray(prototypes))


def load_prototypes(path: str) -> np.ndarray:
    """(C, K) float prototypes from a `.npy`, a `.pth` holding a bare tensor,
    or a path that names a `.npy` without its suffix."""
    if path.endswith('.pth'):
        return load_state_dict(path).numpy()
    if not path.endswith('.npy') and os.path.exists(path + '.npy'):
        path = path + '.npy'
    return np.load(path)
