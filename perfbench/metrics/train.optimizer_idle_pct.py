"""train.optimizer_idle_pct: the share of the traced slice of stage-2 steps
in which the device was idle while the host was inside the program's
`step.optimizer` span, in % (a part of train.idle_pct)."""

from perfbench.work import spans


def read(ctx):
    return spans.idle_pct(ctx, 'step.optimizer')
