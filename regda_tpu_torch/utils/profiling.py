"""Profiling and step-timing hooks (counterpart of regda_tpu/utils/profiling.py).

The reference has no tracing at all, only a wall-clock total at run end
(tools/train_src.py:166). `StepTimer` keeps an EMA'd step time and
throughput; `trace_window` captures a torch.profiler trace (CPU and, where
there is a card, CUDA activity) of the enclosed steps as a Chrome trace;
`annotate` names a region in that trace.
"""

from __future__ import annotations

import contextlib
import os
import time


class StepTimer:
    """EMA'd wall-clock step timing + tiles/sec throughput."""

    def __init__(self, items_per_step: int = 0, decay: float = 0.9):
        self.items = items_per_step
        self.decay = decay
        self.ema = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        return self.record(time.perf_counter() - self._t0)

    def record(self, dt: float) -> float:
        """Fold one step time `dt` (seconds) into the EMA."""
        self.ema = dt if self.ema is None else (
            self.decay * self.ema + (1 - self.decay) * dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.ema if self.ema else 0.0

    @property
    def items_per_sec(self) -> float:
        return self.items * self.steps_per_sec

    def summary(self) -> str:
        return (f'{(self.ema or 0) * 1e3:.1f} ms/step, '
                f'{self.items_per_sec:.2f} items/s')


@contextlib.contextmanager
def trace_window(log_dir: str | None):
    """Capture a torch.profiler trace of the enclosed steps into
    `log_dir/trace.json` (open it in Perfetto or chrome://tracing) when
    `log_dir` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace timeline (torch.profiler.record_function)."""
    import torch
    with torch.profiler.record_function(name):
        yield
