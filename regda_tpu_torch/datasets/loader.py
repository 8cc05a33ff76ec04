"""Batched host-side data loader with threaded prefetch (the port's copy of
regda_tpu/datasets/loader.py, with `make_loader`).

Parity target: regda/datasets/daLoader.py:29-77 (`DALoader`: random sampler
+ drop_last for training, sequential for eval, num_workers=4) and
ever's `Iterator` infinite stream (tools/train_src.py:97-99).

The torch DataLoader's worker *processes* become a thread pool: sample
reading/augmentation is PIL+numpy (releases the GIL for IO and most array
work), batches are prefetched into a bounded queue so the step never
waits on the host. Where the native library loads, a whole batch is decoded
and augmented in C++ (datasets/native_pipeline.py), bit-identical to the
Python path; `paths` counts the batches each path made.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from regda_tpu_torch.datasets.basedata import TileDataset
from regda_tpu_torch.datasets.native_pipeline import native_enabled, try_native_batch


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if k == 'fname' else np.stack(vals)
    return out


class DALoader:
    """Iterable over batches (dict of stacked numpy arrays)."""

    def __init__(self, config: dict, dataset_name: str,
                 seed: int = 2333):
        self.dataset = TileDataset(
            dataset_name,
            image_dir=config['image_dir'],
            mask_dir=config.get('mask_dir'),
            transforms=config.get('transforms'),
            label_type=config.get('label_type', 'id'),
            read_sup=config.get('read_sup', False),
        )
        self.batch_size = config.get('batch_size', 1)
        self.training = config.get('training', False)
        self.num_workers = config.get('num_workers', 4)
        self.native = config.get('native', True)
        self.drop_last = True if self.training else False
        self.seed = seed
        self._epoch = 0
        self.paths = {'native': 0, 'python': 0}
        # optional k-fold cross-validation subset, reference parity with
        # ever's CrossValSamplerGenerator (daLoader.py:36-47: CV dict with
        # k folds / fold index i; i = -1 disables, as all shipped configs
        # do). A seeded shuffle partitions the dataset; training loaders
        # take every fold but i, eval loaders take fold i.
        self._cv_subset = self.compute_cv_subset(
            len(self.dataset), config.get('CV'), self.training, seed)

    @staticmethod
    def compute_cv_subset(n: int, cv: Optional[dict], training: bool,
                          seed: int) -> Optional[np.ndarray]:
        cv = cv or {}
        k, i = int(cv.get('k', 10) or 10), int(cv.get('i', -1))
        if i < 0:
            return None
        if i >= k:
            raise ValueError(f'CV fold i={i} out of range for k={k}')
        order = np.random.default_rng(seed).permutation(n)
        folds = np.array_split(order, k)
        return (np.concatenate([f for j, f in enumerate(folds) if j != i])
                if training else folds[i])

    def _base_indices(self) -> np.ndarray:
        if self._cv_subset is not None:
            return self._cv_subset.copy()
        return np.arange(len(self.dataset))

    def __len__(self):
        n = len(self._base_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = self._base_indices()
        if self.training:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        return idx

    def __iter__(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        nb = len(self)
        rng_seeds = np.random.SeedSequence(
            [self.seed, self._epoch]).generate_state(len(idx))

        def fetch(i):
            return self.dataset.__getitem__(
                int(idx[i]), rng=np.random.default_rng(int(rng_seeds[i])))

        def make_batch(lo, hi, pool=None):
            # native fast path: whole batch decoded + augmented in C++,
            # bit-identical to the Python path (same RNG decisions)
            if self.native:
                rngs = [np.random.default_rng(int(rng_seeds[i]))
                        for i in range(lo, hi)]
                out = try_native_batch(
                    self.dataset, [int(idx[i]) for i in range(lo, hi)], rngs,
                    nthreads=max(self.num_workers, 1))
                if out is not None:
                    self.paths['native'] += 1
                    return out
            self.paths['python'] += 1
            if pool is not None:
                futs = [pool.submit(fetch, i) for i in range(lo, hi)]
                return _collate([f.result() for f in futs])
            return _collate([fetch(i) for i in range(lo, hi)])

        if self.num_workers <= 0:
            for b in range(nb):
                lo = b * self.batch_size
                hi = min(lo + self.batch_size, len(idx))
                yield make_batch(lo, hi)
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            q: "queue.Queue" = queue.Queue(maxsize=4)
            stop = threading.Event()
            failure = []

            def producer():
                try:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        lo = b * self.batch_size
                        hi = min(lo + self.batch_size, len(idx))
                        q.put(make_batch(lo, hi, pool))
                except BaseException as e:  # handed to the consumer below
                    failure.append(e)
                finally:
                    q.put(None)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    batch = q.get()
                    if batch is None:
                        break
                    yield batch
                if failure:
                    raise failure[0]
            finally:
                stop.set()
                while t.is_alive():      # unblock a producer waiting on a full queue
                    try:
                        q.get(timeout=0.1)
                    except queue.Empty:
                        pass


class InfiniteIterator:
    """ever.Iterator equivalent: endless batch stream for step-based loops."""

    def __init__(self, loader: DALoader):
        self.loader = loader
        self._it = iter(loader)

    def next(self) -> dict:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


def make_loader(config: dict, dataset_name: str, seed: int = 2333,
                logger=None) -> DALoader:
    """The training splits' loader: always the host `DALoader` (the JAX
    package's device-resident cache works around its TPU host link and is
    not ported). Logs which decode path its batches will take."""
    loader = DALoader(config, dataset_name, seed=seed)
    if logger is not None:
        native = (loader.native and loader.dataset.label_type == 'id'
                  and native_enabled())
        logger.info(f'host loader over {len(loader.dataset)} tiles: '
                    f'{"native" if native else "Python"} decode path')
    return loader
