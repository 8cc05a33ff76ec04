"""Profiling hooks (counterpart of regda_tpu/utils/profiling.py).

The reference has no tracing at all, only a wall-clock total at run end
(tools/train_src.py:166). `trace_window` captures a torch.profiler trace
(CPU and, where there is a card, CUDA activity) of the enclosed steps as a
Chrome trace; `span` names a region of the port in whatever trace a
profiler is taking, on the same clock as the device's kernels and copies.

The spans, named `<layer>.<what>`: `loop.run_step` and `loop.upload`
(train/loop.py), `step.forward`, `step.pseudo_label`, `step.backward`,
`step.grad_allreduce` and `step.optimizer` (train/steps.py),
`infer.predict`, `infer.upload`, `infer.forward`, `infer.tune` and
`infer.download` (infer.py), `sam.<stage>` (models/sam/auto.py) and
`kernel.<name>` at each public wrapper of ops/kernels/.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `name` in the active profiler's trace
    (torch.profiler.record_function); with no profiler active it does
    nothing beyond asking whether one is, so the instrumented code behaves
    and costs as it would without it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace_window(log_dir: str | None):
    """Capture a torch.profiler trace of the enclosed steps into
    `log_dir/trace.json` (open it in Perfetto or chrome://tracing) when
    `log_dir` is set; no-op otherwise. The trace carries the spans."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
