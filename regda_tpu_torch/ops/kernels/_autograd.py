"""Backward of a kernel wrapper through its plain version.

The JAX package's forward kernels have no backward kernels: each
`custom_vjp` differentiates the kernel's stock twin. The wrappers here do
the same with `torch.autograd`.
"""

from __future__ import annotations

import torch


def grad_through_plain(plain, tensors, needs, grad):
    """Gradients of `plain(*tensors)` w.r.t. the tensors flagged in `needs`,
    for the output gradient `grad`; None for the others."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
    with torch.enable_grad():
        out = plain(*leaves)
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)
