"""train.upload_host_ms: the host's milliseconds a step inside the program's
`loop.upload` span (Trainer.run_step's upload of the batch's host arrays,
waits for the device included) in the traced slice of stage-2 steps."""

from perfbench.work import spans


def read(ctx):
    return spans.host_ms(ctx, 'loop.upload')
