"""The least time a hand kernel of the port can take for the work of one
launch, from the launch's shapes, and what per-layer readers share.

A kernel's bound is the larger of its bytes over the card's memory rate
and its operations over the peak of its precision (work/peaks.json). Each
input byte counts once as read and each output byte once as written,
whatever the kernel reads again; only the work these inputs need counts.
Which profiler kernels belong to a hand kernel is `work/kernels/<k>.json`.
"""

from __future__ import annotations

import json
from pathlib import Path

WORK_DIR = Path(__file__).resolve().parent


def peaks() -> dict:
    with open(WORK_DIR / 'peaks.json') as f:
        return json.load(f)


def patterns(kernel: str) -> list:
    with open(WORK_DIR / 'kernels' / f'{kernel}.json') as f:
        return json.load(f)['patterns']


def bound_s(bytes_moved: float, flops: float = 0.0, precision: str = 'f32') -> float:
    p = peaks()
    return max(bytes_moved / p['hbm_bytes_per_s'], flops / p['flops_per_s'][precision])


def segment_hist_bytes(batch: int, pixels: int, regions: int, classes: int) -> int:
    """(B, N) int32 labels and (B, N) int32 region ids read, the (B, R, C)
    float32 histogram written; its N additions an image are no share of
    any peak."""
    return 2 * batch * pixels * 4 + batch * regions * classes * 4


def segment_hist_bound_s(batch: int, pixels: int, regions: int, classes: int) -> float:
    return bound_s(segment_hist_bytes(batch, pixels, regions, classes))


# ------------------------------------------------------- for the readers

def idle_pct(ctx):
    """The traced slice's share of time in which no operation ran on the
    device, in %."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu_pct(ctx, flops_per_item: float, precision: str):
    """The work of the traced slice's items over its length, as a share of
    the card's peak in `precision`, in %."""
    if ctx.trace is None or ctx.trace.items <= 0:
        return None
    rate = flops_per_item * ctx.trace.items / ctx.trace.window_s
    return 100.0 * rate / peaks()['flops_per_s'][precision]


def roofline_pct(ctx, kernel: str, bound_per_launch_s: float):
    """The kernel's launches in the traced slice: their bounds summed over
    their device time summed, in %; None where the slice holds none."""
    if ctx.trace is None:
        return None
    ops = ctx.trace.ops(patterns(kernel), cats=('kernel',))
    spent = sum(b - a for _, _, a, b in ops)
    if not ops or spent <= 0:
        return None
    return 100.0 * len(ops) * bound_per_launch_s / spent
