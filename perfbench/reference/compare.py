"""The numbers a check compares, each computed from the program's output and
the reference's.

Training (three steps through the window's own call): the widest relative
gap of a step's loss; the first gradient and the parameters' change after
the steps each by the worst leaf: the gap between the program's norm of a
leaf and the reference's, against the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change (`MOVING`).
"""

from __future__ import annotations

import math
import statistics

MOVING = 1e-3


def _worst(gaps) -> float:
    """The largest gap, infinite where one is not a number."""
    gaps = list(gaps)
    return math.inf if any(not math.isfinite(g) for g in gaps) else max(gaps)


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def worst_leaf(program: dict, reference: dict, leaves=None) -> float:
    ref, prog = _norms(reference), _norms(program)
    keys = sorted(ref) if leaves is None else sorted(leaves)
    floor = statistics.median(ref[k] for k in keys)
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys)


def training(program, reference) -> dict:
    """program, reference: (losses, first gradient, change) each."""
    (p_loss, p_grad, p_change), (r_loss, r_grad, r_change) = program, reference
    if sorted(p_grad) != sorted(r_grad):
        raise ValueError('the program and the reference name their parameters apart: '
                         f'{sorted(set(p_grad) ^ set(r_grad))[:5]}')
    grad_norms = _norms(r_grad)
    floor = statistics.median(grad_norms.values())
    moving = [k for k, n in grad_norms.items() if n >= MOVING * floor]
    loss_gap = _worst(abs(p - r) / abs(r) for p, r in zip(p_loss, r_loss))
    return {'loss_gap': loss_gap,
            'grad_gap': worst_leaf(p_grad, r_grad),
            'change_gap': worst_leaf(p_change, r_change, moving)}
