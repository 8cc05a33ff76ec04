"""train.upload_ms: the device time of host-to-device copies a step in the
traced slice: run_step's upload of the batch's host arrays."""


def read(ctx):
    if ctx.trace is None or ctx.trace.items <= 0:
        return None
    copies = ctx.trace.ops(['HtoD'], cats=('gpu_memcpy',))
    if not copies:
        return None
    return 1e3 * sum(b - a for _, _, a, b in copies) / ctx.trace.items
