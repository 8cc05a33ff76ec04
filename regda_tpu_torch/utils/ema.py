"""Exponential moving average of a model's weights (counterpart of
regda_tpu/utils/ema.py).

Reference: regda/utils/ema.py:34-65 (`ExponentialMovingAverage`, which
train_ssl_reg.py imports and never builds). The shadow is an explicit
`EmaState` the caller keeps, as in the JAX package; it works on a module's
parameters (or on a name -> tensor mapping): register, update, apply the
shadow for evaluation, restore the training weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Union

import torch

Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclass
class EmaState:
    shadow: dict[str, torch.Tensor]   # name -> EMA of the parameter


@torch.no_grad()
def ema_register(params: Params) -> EmaState:
    """The current parameters as the shadow (ema.py:41-44)."""
    return EmaState({k: v.detach().clone() for k, v in _named(params).items()})


@torch.no_grad()
def ema_update(state: EmaState, params: Params, decay: float) -> EmaState:
    """shadow <- decay * shadow + (1 - decay) * params (ema.py:46-51)."""
    named = _named(params)
    return EmaState({k: decay * s + (1.0 - decay) * named[k].detach()
                     for k, s in state.shadow.items()})


@torch.no_grad()
def ema_apply_shadow(state: EmaState, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Copy the shadow into `module`'s parameters for evaluation and return a
    backup of the training weights for `ema_restore` (ema.py:53-59)."""
    named = _named(module)
    backup = {k: named[k].detach().clone() for k in state.shadow}
    for k, s in state.shadow.items():
        named[k].copy_(s)
    return backup


@torch.no_grad()
def ema_restore(module: torch.nn.Module, backup: Mapping[str, torch.Tensor]) -> None:
    """Put the training weights that `ema_apply_shadow` saved back
    (ema.py:61-65)."""
    named = _named(module)
    for k, v in backup.items():
        named[k].copy_(v)
