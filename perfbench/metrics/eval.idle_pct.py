"""eval.idle_pct: 1 - the union of the device's kernels and copies over
the traced slice of eval tiles, in %."""

from perfbench.work import bounds


def read(ctx):
    return bounds.idle_pct(ctx)
