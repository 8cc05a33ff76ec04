"""train.optimizer_launches: the kernel launches a step that the host made
inside the program's `step.optimizer` span in the traced slice of stage-2
steps."""

from perfbench.work import spans


def read(ctx):
    return spans.launches(ctx, 'step.optimizer')
