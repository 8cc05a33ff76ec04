"""What the program's own spans show in a traced slice, for the readers of
`program_span` metrics.

The port marks its phases with `torch.profiler.record_function` spans
(`regda_tpu_torch/utils/profiling.py:span`, named `<layer>.<what>`), which
the trace holds as `user_annotation` host events on the device trace's
clock. Over `ctx.trace` (harness.Trace) this module gives, for the spans of
one name: their host milliseconds an item, the kernel launches (`cuda_runtime`
events whose name holds `LaunchKernel`) that start inside them an item, and
the share of the slice in which the device was idle while the host was
inside them. Spans of one name that nest or overlap count once: every
measure is taken over the union of their intervals, clipped to the slice.
Each returns None where the slice holds no span of the name, and where the
program has no such span, as an older one has not.
"""

from __future__ import annotations

SPAN_CAT = 'user_annotation'
LAUNCH_CAT = 'cuda_runtime'
LAUNCH = 'LaunchKernel'


def union(intervals, end: float) -> list:
    """The union of (start, end) intervals clipped to [0, end], as sorted
    disjoint [start, end] pairs."""
    out = []
    for a, b in sorted((max(0.0, a), min(end, b)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_s(xs: list, ys: list) -> float:
    """Seconds that two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, name: str) -> list:
    """The union of the slice's spans called `name`; [] where it has none."""
    if trace is None:
        return []
    return union(((a, b) for n, cat, a, b in trace.host if cat == SPAN_CAT and n == name),
                 trace.window_s)


def host_ms(ctx, name: str):
    """Milliseconds an item that the host spent inside the spans."""
    inside = spans(ctx.trace, name)
    if not inside or ctx.trace.items <= 0:
        return None
    return 1e3 * sum(b - a for a, b in inside) / ctx.trace.items


def launches(ctx, name: str):
    """Kernel launches an item that started inside the spans; None also
    where the slice holds no launch at all (a trace without the device)."""
    inside = spans(ctx.trace, name)
    if not inside or ctx.trace.items <= 0:
        return None
    starts = [a for n, cat, a, _ in ctx.trace.host if cat == LAUNCH_CAT and LAUNCH in n]
    if not starts:
        return None
    return sum(any(lo <= t < hi for lo, hi in inside) for t in starts) / ctx.trace.items


def idle_pct(ctx, name: str):
    """The share of the slice, in %, in which no operation ran on the
    device while the host was inside the spans: their union less its
    overlap with the union of the device's operations."""
    inside = spans(ctx.trace, name)
    if not inside or ctx.trace.window_s <= 0:
        return None
    busy = union(((a, b) for _, _, a, b in ctx.trace.device), ctx.trace.window_s)
    idle = sum(b - a for a, b in inside) - overlap_s(inside, busy)
    return 100.0 * idle / ctx.trace.window_s
