"""Shared host-side training-loop plumbing of the stage CLIs (counterpart of
regda_tpu/train/loop.py).

Mirrors the reference loops' cadence (tools/train_src.py:108-166): loss log
every 50 steps, evaluate + checkpoint every EVAL_EVERY, keep `_best` by
mIoU and copy the vis dir. A step is one call of a step from
train/steps.py on a batch on the model's device: a host loader's numpy
arrays are uploaded there, and a DeviceLoader's tensors, assembled on that
device already (datasets/device_data.py), are taken as they are.

Checkpoints, under SNAPSHOT_DIR: `<TARGET_SET>_curr.pth` and `_best.pth`
(the model's state_dict under the reference's key names) and `_state.pth`
with its `.json` sidecar (the full train state and the best mIoU, for
`--auto-resume`). They are written by a background thread from a host copy
taken before training goes on, since the step updates the parameters in
place; REGDA_SYNC_CKPT=1 writes them in the loop instead.

With a `group` (parallel.DataGroup, one process per card under `torchrun`)
the Trainer is one rank of a data-parallel run, the counterpart of the JAX
Trainer's batch sharding over its devices: every rank reads the loader's
whole global batch and uploads only its own rows (a DeviceLoader on every
rank holds the whole split and draws the same global batch from the same
seed, and each rank takes its rows of it), so N ranks step through
exactly the one-process run's batches (the step functions take the same
group); evaluation and pseudo-labelling go through the inferencer's group
(each rank predicts its share of a batch and the results are gathered);
only the first rank logs and writes checkpoints; `try_resume` reads the
state on the first rank and broadcasts it. A world size that does not
divide the batch is refused, where the JAX Trainer quietly uses
the largest divisor of the batch that is at most its device count.
"""

from __future__ import annotations

import atexit
import copy
import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

import torch

from regda_tpu_torch.datasets import get_meta
from regda_tpu_torch.datasets.device_data import batch_tensor
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.ops.losses import ClassBalanceState, GHMState
from regda_tpu_torch.parallel.mesh import (DataGroup, broadcast_object, is_primary, rows,
                                           shard_batch)
from regda_tpu_torch.train.state import TrainState
from regda_tpu_torch.utils.checkpoint import load_state_dict, save_state_dict, to_host
from regda_tpu_torch.utils.convert import load_segmenter_state_dict
from regda_tpu_torch.utils.eval import evaluate
from regda_tpu_torch.utils.profiling import span, trace_window


class Trainer:
    def __init__(self, model, cfg, logger, state: TrainState, step_fn: Callable,
                 group: Optional[DataGroup] = None):
        self.model = model
        self.group = group
        self.cfg = cfg
        self.logger = logger
        self.state = state
        self.step_fn = step_fn
        self.meta = get_meta(cfg.DATASETS)
        self.device = next(model.parameters()).device
        batch_size = cfg.SOURCE_DATA_CONFIG.get('batch_size', 1)
        if group is not None and group.spatial:
            raise ValueError('the Trainer runs on the data axis only (n_spatial 1), as the '
                             'JAX Trainer pins it; the stage steps take a spatial group')
        rows(group, batch_size)      # refuses a world size that does not divide it
        self.batch_size = batch_size
        self.step_seconds: list[float] = []    # host clock of each run_step
        self._log_mark = None    # (host clock, steps run) at the previous log line
        # profile 5 steps starting at REGDA_PROFILE_START (default 10) into
        # SNAPSHOT_DIR/trace when enabled via cfg.PROFILE=1 or
        # REGDA_PROFILE=1 (the reference has no tracing; SURVEY.md §5)
        self._profile = bool(getattr(cfg, 'PROFILE', 0)
                             or os.environ.get('REGDA_PROFILE'))
        self._profile_start = int(os.environ.get('REGDA_PROFILE_START', 10))
        self._trace_ctx = None
        # evaluation serves a second instance of the model: an inferencer
        # over the training module itself could leave it in eval mode
        self.inferencer = SegInferencer(copy.deepcopy(model), self.meta.num_classes,
                                        group=group)
        self.eval_seconds: list[float] = []
        self.mIoU_max = 0.0
        self.iter_max = 0
        self._saver = None
        self._saver_exc = None
        self._async_ckpt = os.environ.get('REGDA_SYNC_CKPT', '0') != '1'
        # seconds spent taking host copies, writing checkpoint chains (in
        # the background thread when async) and waiting in join_saver
        self.ckpt_seconds = {'snapshot': 0.0, 'chain': 0.0, 'join_wait': 0.0}

    def _close_trace(self):
        if self._trace_ctx is not None:
            self._trace_ctx.__exit__(None, None, None)
            self._trace_ctx = None

    def run_step(self, i_iter: int = -1, **arrays):
        """One step on `arrays` (the global batch: numpy arrays, or tensors on
        the model's device), passed to the step in keyword order; with a
        group, this rank's rows only."""
        if self._profile:
            if i_iter == self._profile_start:
                self._trace_ctx = trace_window(
                    os.path.join(self.cfg.SNAPSHOT_DIR, 'trace'))
                self._trace_ctx.__enter__()
                atexit.register(self._close_trace)  # short runs still flush
            elif (i_iter == self._profile_start + 5
                  and self._trace_ctx is not None):
                self._close_trace()
        t0 = time.perf_counter()
        if self._log_mark is None:
            self._log_mark = (t0, len(self.step_seconds))
        with span('loop.run_step'):
            with span('loop.upload'):
                batch = [batch_tensor(a, self.device)
                         for a in shard_batch(self.group, *arrays.values())]
            metrics = self.step_fn(self.state, *batch)
        self.step_seconds.append(time.perf_counter() - t0)
        return metrics

    def maybe_log(self, i_iter: int, metrics: dict, extra: str = ''):
        if not is_primary(self.group):
            return
        if i_iter == 0 or (i_iter + 1) % 50 == 0:
            parts = [f'iter={i_iter + 1}']
            parts += [f'{k}={float(v):.3f}' for k, v in metrics.items()]
            parts.append(self._pace())
            lr_line = ', '.join(parts)
            self.logger.info(lr_line + (f', {extra}' if extra else ''))

    def _pace(self) -> str:
        """ms/step and items/s over the steps since the previous log line
        (or the first step), by the host clock; the caller's float() of the
        metrics has waited for the device already."""
        now, steps = time.perf_counter(), len(self.step_seconds)
        t, n = self._log_mark or (now, steps)
        self._log_mark = (now, steps)
        if steps <= n:
            return '0.0 ms/step, 0.00 items/s'
        dt = now - t
        return (f'{dt / (steps - n) * 1e3:.1f} ms/step, '
                f'{self.batch_size * (steps - n) / dt:.2f} items/s')

    # ------------------------------------------------------ elastic resume
    @property
    def _state_path(self):
        return os.path.join(self.cfg.SNAPSHOT_DIR,
                            self.cfg.TARGET_SET + '_state.pth')

    def host_state(self) -> dict:
        """The full train state (model, optimizer with its momentum buffers
        and count, prototypes, class-balance EMAs, GHM histogram, dropout
        generator, step) copied to host memory."""
        st = self.state
        return {'model': to_host(st.model.state_dict()),
                'optimizer': to_host(st.optimizer.state_dict()),
                'optimizer_count': st.optimizer.count,
                'prototypes': to_host(st.prototypes),
                'class_freq_s': to_host(st.class_freq_s.freq),
                'class_freq_t': to_host(st.class_freq_t.freq),
                'ghm': to_host(st.ghm.acc_sum),
                'generator': st.generator.get_state(),
                'step': st.step}

    def save_state(self, host_state: Optional[dict] = None):
        """Persist the FULL train state so a crashed run resumes exactly —
        the reference can only restart from manually passed weight files
        (SURVEY.md section 5: no failure recovery). host_state: a copy from
        `host_state()` already taken."""
        save_state_dict(self._state_path,
                    host_state if host_state is not None else self.host_state())
        # atomic sidecar write: a crash mid-write must not leave a truncated
        # JSON that breaks --auto-resume (or silently resets mIoU_max)
        tmp = self._state_path + '.json.tmp'
        with open(tmp, 'w') as f:
            json.dump({'mIoU_max': self.mIoU_max,
                       'iter_max': self.iter_max}, f)
        os.replace(tmp, self._state_path + '.json')

    def try_resume(self) -> int:
        """Restore the full train state if one exists in SNAPSHOT_DIR.
        Returns the iteration to resume from (0 = fresh run). With a group
        the first rank reads the files and broadcasts what it read."""
        found = None
        if is_primary(self.group) and os.path.exists(self._state_path):
            found = (load_state_dict(self._state_path), self._read_sidecar())
        found = broadcast_object(found, self.group)
        if found is None:
            return 0
        saved, meta = found
        st = self.state
        load_segmenter_state_dict(st.model, saved['model'])
        st.optimizer.load_state_dict(saved['optimizer'])
        st.optimizer.count = int(saved['optimizer_count'])
        st.prototypes = saved['prototypes'].to(st.prototypes.device)
        st.class_freq_s = ClassBalanceState(saved['class_freq_s'].to(self.device))
        st.class_freq_t = ClassBalanceState(saved['class_freq_t'].to(self.device))
        st.ghm = GHMState(saved['ghm'].to(self.device))
        st.generator.set_state(saved['generator'])
        st.step = int(saved['step'])
        if meta is not None:
            self.mIoU_max = float(meta.get('mIoU_max', 0.0))
            self.iter_max = int(meta.get('iter_max', 0))
        self.logger.info(f'auto-resume: restored {self._state_path} at '
                         f'step {st.step} (best mIoU {self.mIoU_max:.4f} '
                         f'@ iter {self.iter_max})')
        return st.step

    def _read_sidecar(self) -> Optional[dict]:
        """The `_state.pth.json` sidecar, or None where it is missing or
        unreadable (then the best mIoU is kept)."""
        meta_path = self._state_path + '.json'
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                return json.load(f)
        except (ValueError, OSError) as e:
            self.logger.warning(
                f'auto-resume: unreadable sidecar {meta_path} ({e}); '
                'keeping mIoU_max=%.4f' % self.mIoU_max)
            return None

    def maybe_eval(self, i_iter: int, stop_steps: int,
                   eval_at_zero: bool = False) -> Optional[float]:
        due = ((i_iter + 1) % self.cfg.EVAL_EVERY == 0
               or (i_iter + 1) >= stop_steps
               or (eval_at_zero and i_iter == 0))
        if not due:
            return None
        self.join_saver()          # at most one checkpoint chain in flight
        ckpt_path = os.path.join(self.cfg.SNAPSHOT_DIR,
                                 self.cfg.TARGET_SET + '_curr.pth')
        t0 = time.perf_counter()
        _, mIoU_curr = evaluate(self.model, self.state.model.state_dict(),
                                self.cfg, is_training=True, ckpt_path=ckpt_path,
                                logger=self.logger, inferencer=self.inferencer)
        self.eval_seconds.append(time.perf_counter() - t0)
        improved = self.mIoU_max <= mIoU_curr
        if improved:
            self.mIoU_max = mIoU_curr
            self.iter_max = i_iter + 1
        if not is_primary(self.group):
            return mIoU_curr       # the first rank writes the checkpoints
        self.logger.info(
            f'Best model in iter={self.iter_max}, best_mIoU={self.mIoU_max}.')

        t0 = time.perf_counter()
        snap = self.host_state()
        self.ckpt_seconds['snapshot'] += time.perf_counter() - t0

        def _save_chain():
            t0 = time.perf_counter()
            save_state_dict(ckpt_path, snap['model'])
            if improved:
                best_path = os.path.join(self.cfg.SNAPSHOT_DIR,
                                         self.cfg.TARGET_SET + '_best.pth')
                save_state_dict(best_path, snap['model'])
                best_vis = os.path.join(self.cfg.SNAPSHOT_DIR,
                                        f'vis-{self.cfg.TARGET_SET}_best')
                curr_vis = os.path.join(self.cfg.SNAPSHOT_DIR,
                                        f'vis-{os.path.basename(ckpt_path)}')
                if os.path.isdir(best_vis):
                    shutil.rmtree(best_vis)
                if os.path.isdir(curr_vis):
                    shutil.copytree(curr_vis, best_vis)
            self.save_state(snap)
            self.ckpt_seconds['chain'] += time.perf_counter() - t0

        if self._async_ckpt:
            def _save_chain_capture():
                # A failed background save must not report success: stash
                # the exception and re-raise it at the next join point
                # (join_saver / the next eval / end of training).
                try:
                    _save_chain()
                except BaseException as e:  # noqa: BLE001
                    self._saver_exc = e

            self._saver = threading.Thread(target=_save_chain_capture,
                                           name='ckpt-saver')
            self._saver.start()
        else:
            _save_chain()
        return mIoU_curr

    def join_saver(self):
        """Block until the in-flight async checkpoint chain (if any) has
        fully written _curr/_best/_state to disk; re-raise any exception
        the background chain hit so a lost checkpoint cannot masquerade
        as a successful save."""
        if self._saver is not None:
            t0 = time.perf_counter()
            self._saver.join()
            self.ckpt_seconds['join_wait'] += time.perf_counter() - t0
            self._saver = None
        exc = self._saver_exc
        if exc is not None:
            self._saver_exc = None
            raise RuntimeError('async checkpoint chain failed') from exc
