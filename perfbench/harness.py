"""The general part of the benchmark of `regda_tpu_torch` (the PyTorch and
CUDA port). It knows no cell, configuration, traffic mix or metric by name:
everything of those is found by the names that `BENCHMARK.json` gives.

- a configuration `<c>` is `perfbench/configs/<c>.json` (the file that
  `BENCHMARK.json` names), its plain reference is under `perfbench/reference/`;
- a traffic mix `<t>` is `perfbench/traffic/<t>.json`, a data file whose
  `runner` names the general code in `perfbench/runners/<runner>.py` that
  builds the system, warms it up, runs the window and checks what it
  produced against the reference;
- a cell's limits, the numbers its check compares and the limit of each,
  are `perfbench/limits/<cell>.json`;
- a metric `<m>` is read by `perfbench/metrics/<m>.py`, whose `read(ctx)`
  returns a number, or None where it finds nothing to read.

A runner module has four functions:
  setup(cell, seed, device) -> system   (everything up to the window)
  window(system, seconds, tracer) -> samples   (the measured window)
  check(system, samples) -> Check   (frees the program, runs the reference)
  control(cell, seed, device) -> numbers   (the control's readings, for
      `perfbench/control.py`; no run calls it)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# whole top-level module names that no run may load: the JAX stack, the JAX
# package and the repository's root `configs` package, which imports it
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'regda_tpu', 'configs')


def process_start_epoch() -> float:
    """The time.time() at which this process started (from /proc), or, where
    /proc cannot tell, the time this module was imported."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        ticks = os.sysconf('SC_CLK_TCK')
        with open('/proc/stat') as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith('btime'))
        return btime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules(names) -> list[str]:
    """The module names among `names` whose top-level name (the part before
    the first dot) is, compared whole, one of FORBIDDEN_MODULES."""
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN_MODULES)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    name = 'perfbench_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f'cannot load {path}')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's content
    mix: dict             # the traffic mix's content
    limits: dict          # name -> limit of each number the check compares
    root: Path

    def runner(self):
        return load_module(self.root / 'perfbench' / 'runners' / f"{self.mix['runner']}.py")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: with --trace 0 the end-to-end
    ones, with --trace 1 the per-layer ones; each where its `workloads`
    lists the cell or, without that key, where the cell reports what it
    moves (a per-layer metric) or always (an end-to-end one)."""
    e2e = [m for m in bench['end_to_end'] if cell in m.get('workloads', [cell])]
    if not trace:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if (cell in m['workloads'] if 'workloads' in m else m['moves'] in names)]


def load_cell(name: str, root: Path = ROOT) -> tuple[Cell, dict]:
    bench = load_json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json (has {sorted(cells)})')
    w = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    config = load_json(root / configs[w['config']]['file'])
    mix = load_json(root / 'perfbench' / 'traffic' / f"{w['traffic']}.json")
    limits = load_json(root / 'perfbench' / 'limits' / f'{name}.json')
    return Cell(name, int(w['chips']), config, mix, limits, root), bench


# ------------------------------------------------------------------ traces

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'python_function')
WINDOW_SPAN = 'perfbench.window'


@dataclasses.dataclass
class Trace:
    """What a traced slice of the window shows: its length, the device's
    operations in it (name, cat, start s, end s; the start of the slice
    is 0) and the host's events."""
    window_s: float
    items: int
    device: list
    host: list

    @property
    def busy_s(self) -> float:
        """Seconds of the slice in which some operation ran on the device:
        the union of the operations' intervals, clipped to the slice."""
        return sum(b - a for a, b in self._union())

    def _union(self) -> list:
        spans = sorted((max(0.0, a), min(self.window_s, b)) for _, _, a, b in self.device)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def ops(self, patterns=None, cats=DEVICE_CATS) -> list:
        """Device operations of the given kinds whose name holds one of
        `patterns` (all of them without patterns)."""
        return [e for e in self.device if e[1] in cats
                and (patterns is None or any(p in e[0] for p in patterns))]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and the
        longest idle gaps, each named by what the host was doing in its
        middle (the innermost host event there) and the operation after it."""
        by_name: dict[str, float] = {}
        for name, _, a, b in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self._union()
        edges = [0.0] + [x for ab in busy for x in ab] + [self.window_s]
        gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:top]
        by_start = sorted(self.device, key=lambda e: e[2])
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [h for h in self.host if h[2] <= mid <= h[3]]
            host = min(inner, key=lambda h: h[3] - h[2])[0] if inner else 'no host event'
            after = next((e[0] for e in by_start if e[2] >= b - 1e-9), 'end of slice')
            named.append([f'host {host[:60]} | before {after[:60]}', b - a])
        return {'device_ops': [[n[:120], s] for n, s in ops], 'idle_gaps': named}


def parse_chrome_trace(path: Path, items: int) -> Trace:
    """Read the profiler's Chrome trace: the slice is the WINDOW_SPAN
    annotation, and every device operation and host event is kept with
    times in seconds from its start."""
    events = load_json(path)
    events = events['traceEvents'] if isinstance(events, dict) else events
    span = [e for e in events if e.get('name') == WINDOW_SPAN
            and e.get('cat') == 'user_annotation' and 'dur' in e]
    if not span:
        raise RuntimeError(f'the trace holds no {WINDOW_SPAN!r} span')
    t0, dur = float(span[0]['ts']), float(span[0]['dur'])
    device, host = [], []
    for e in events:
        if 'dur' not in e or e.get('ph') != 'X':
            continue
        cat = str(e.get('cat', '')).lower()
        a = (float(e['ts']) - t0) * 1e-6
        row = (str(e.get('name', '')), cat, a, a + float(e['dur']) * 1e-6)
        if cat in DEVICE_CATS:
            device.append(row)
        elif cat in HOST_CATS and row[0] != WINDOW_SPAN:
            host.append(row)
    return Trace(dur * 1e-6, items, device, host)


class Tracer:
    """Traces the first `items` items of a window with torch.profiler (off
    where `items` is 0). The runner calls `start()` as the window opens and
    `item_done()` after each item; the slice closes after `items` items, or
    at `stop()`, each time after a synchronize, so that the slice holds the
    device work of its items. The rest of the window runs untraced, and
    `close()`, after the window, reads the trace."""

    def __init__(self, items: int, device):
        self.items, self.device = items, device
        self.done = 0
        self.trace: Optional[Trace] = None
        self._prof = self._span = None
        self._open = False

    def start(self) -> None:
        if self.items <= 0:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._open = True

    def item_done(self) -> None:
        self.done += 1
        if self._open and self.done >= self.items:
            self.stop()

    def stop(self) -> None:
        if not self._open:
            return
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._open = False
        self._items = self.done

    def close(self) -> None:
        self.stop()
        if self._prof is None:
            return
        with tempfile.TemporaryDirectory(prefix='perfbench_trace_') as tmp:
            path = Path(tmp) / 'trace.json'
            self._prof.export_chrome_trace(str(path))
            self.trace = parse_chrome_trace(path, self._items)
        self._prof = self._span = None


# --------------------------------------------------------------- the check

@dataclasses.dataclass
class Check:
    """What a runner's check found: each number compared with its limit,
    the operations attempted in the window and those that failed."""
    numbers: dict          # name -> value
    limits: dict           # name -> limit
    attempted: int
    failed: int

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and set(self.numbers) == set(self.limits)
                and all(math.isfinite(v) and v <= self.limits[k]
                        for k, v in self.numbers.items()))

    def table(self) -> dict:
        return {k: {'value': v, 'limit': self.limits.get(k)} for k, v in self.numbers.items()}


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: Cell
    samples: dict
    setup_s: float
    trace: Optional[Trace]


def run_cell(cell: Cell, bench: dict, seed: int, seconds: float, trace: bool,
             device, started: float) -> dict:
    """Set up, measure and check one run of `cell`; returns the result line
    as a dict (`checks` last). `started` is the time.time() the set-up
    counts from."""
    import torch
    runner = cell.runner()
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    system = runner.setup(cell, seed, device)
    setup_s = time.time() - started
    tracer = Tracer(int(cell.mix.get('trace_items', 0)) if trace else 0, device)
    samples = runner.window(system, seconds, tracer)
    tracer.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    check = runner.check(system, samples)
    del system
    ctx = Context(cell, samples, setup_s, tracer.trace)
    metrics = {}
    for m in cell_metrics(bench, cell.name, trace):
        value = load_module(cell.root / 'perfbench' / 'metrics' / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    result = {'correct': check.correct, 'attempted': check.attempted, 'failed': check.failed,
              'metrics': metrics, 'device': dev}
    if tracer.trace is not None:
        dev['busy_s'] = tracer.trace.busy_s
        dev['window_s'] = tracer.trace.window_s
        result['breakdown'] = tracer.trace.breakdown()
    result['checks'] = check.table()
    return result


def print_result(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
