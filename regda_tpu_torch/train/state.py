"""Training state and optimizer (counterpart of regda_tpu/train/state.py).

The JAX package threads one immutable TrainState through a jitted step; here
the state is a plain dataclass whose model and optimizer update in place.

Optimizer parity (state.py:46-56, reference tools/train_src.py:106-141): the
optax chain clip_by_global_norm(32) -> add_decayed_weights(5e-4) ->
trace(0.9) -> scale_by_learning_rate(poly_warmup_lr(count)). `PolySGD` is
torch's SGD (momentum 0.9, dampening 0, weight decay on every parameter, BN
included) behind optax's clip (g * max_norm / norm when norm >= max_norm,
without torch's +1e-6) with the lr set from the schedule before each update;
count is 0 at the first update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from regda_tpu_torch.models.deeplabv2 import DeeplabV2
from regda_tpu_torch.ops.losses import ClassBalanceState, GHMState
from regda_tpu_torch.ops.schedule import poly_warmup_lr


class PolySGD(torch.optim.SGD):
    def __init__(self, params, base_lr: float, stop_steps: int,
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_norm: float = 32.0, power: float = 0.9):
        super().__init__(params, lr=base_lr, momentum=momentum,
                         weight_decay=weight_decay, dampening=0.0)
        self.base_lr, self.stop_steps = base_lr, stop_steps
        self.clip_norm, self.power = clip_norm, power
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g['params']
                 if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        lr = poly_warmup_lr(self.count, self.base_lr, self.stop_steps, power=self.power)
        for group in self.param_groups:
            group['lr'] = lr
        super().step()
        self.count += 1


def make_optimizer(model: torch.nn.Module, base_lr: float, stop_steps: int,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   clip_norm: float = 32.0, power: float = 0.9) -> PolySGD:
    return PolySGD(model.parameters(), base_lr, stop_steps, momentum,
                   weight_decay, clip_norm, power)


@dataclass
class TrainState:
    model: DeeplabV2
    optimizer: PolySGD
    prototypes: torch.Tensor          # (C, K)
    class_freq_s: ClassBalanceState
    class_freq_t: ClassBalanceState
    ghm: GHMState                     # stage 3's GHM target loss
    generator: torch.Generator        # head dropout
    step: int = 0


def create_train_state(model: DeeplabV2, optimizer: PolySGD,
                       generator: torch.Generator,
                       prototypes: Optional[torch.Tensor] = None) -> TrainState:
    """State on the model's device around (C, K) initial prototypes: a
    prototype checkpoint, or, when none is given, zeros of the encoder's
    width (512 for resnet18/34, 2048 otherwise), as the JAX package starts
    stage 1."""
    device = next(model.parameters()).device
    if prototypes is None:
        prototypes = torch.zeros(model.num_classes, model.encoder.resnet.out_channels)
    num_classes = prototypes.shape[0]
    return TrainState(
        model=model, optimizer=optimizer,
        prototypes=prototypes.to(device=device, dtype=torch.float32),
        class_freq_s=ClassBalanceState.create(num_classes, device),
        class_freq_t=ClassBalanceState.create(num_classes, device),
        ghm=GHMState.create(device=device),
        generator=generator)
