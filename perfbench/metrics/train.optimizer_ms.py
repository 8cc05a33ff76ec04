"""train.optimizer_ms: the host's milliseconds a step inside the program's
`step.optimizer` span (PolySGD.step: the clip, the lr, the SGD update) in
the traced slice of stage-2 steps."""

from perfbench.work import spans


def read(ctx):
    return spans.host_ms(ctx, 'step.optimizer')
