"""Device-resident dataset cache and on-device batch assembly (counterpart of
regda_tpu/datasets/device_data.py).

The host loader (datasets/loader.py) decodes and augments every batch on the
host, and the Trainer uploads it each step. Here a whole split is uploaded
once as compact integers (uint8 images, int8 id-labels, int16 region maps,
bf16 soft labels), and every batch is assembled on the cache's device:
index gather, random crop, flip / rot90 and Normalize, the gather, crop and
geometric op fused into one index map a sample. A step's host-to-device
traffic drops to the batch's indices.

Randomness comes from a `torch.Generator` on the cache's device, seeded
from `seed`, so the decision stream differs from the host loader's numpy
stream (as the JAX package's `jax.random` stream does), but each decision's
distribution is that of the host stacks (configs/_base.py):

  - train stack: RandomCrop(c); OneOf([hflip, vflip, rot90 k~U{0..3}],
                 p=0.75); Normalize
  - prob stack:  RandomCrop(c); hflip(.5); vflip(.5); rot90(k=1, .5);
                 Normalize(clamp)
  - eval stack:  Normalize only

The geometric ops are exact permutations, bit-identical to the host ones
(tests/test_torch_device_data.py holds them against the JAX package's).
A batch has the keys, shapes, dtypes and (B, H, W, C) layout of the host
`DALoader`'s batch after the Trainer's upload, as tensors on the device, so
every step function takes it unchanged.

Off by default: `REGDA_DEVICE_DATA=1` or a data config's `device_data=True`
turns it on (`device_data_enabled`). Whether CUDA should default to it is a
question for measurement, not settled here.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from regda_tpu_torch.aug.augmentation import (Compose, Normalize, OneOf, RandomCrop,
                                              RandomHorizontalFlip, RandomRotate90,
                                              RandomVerticalFlip)
from regda_tpu_torch.datasets.basedata import TileDataset, read_image
from regda_tpu_torch.datasets.loader import DALoader
from regda_tpu_torch.datasets.native_pipeline import native_enabled

_log = logging.getLogger(__name__)

DEFAULT_BUDGET = 8 << 30     # bytes of cache a split, REGDA_DEVICE_DATA_BUDGET overrides


def device_data_enabled(config: dict) -> bool:
    """REGDA_DEVICE_DATA=0/1 decides, then `config['device_data']`; the
    default is off, the JAX package's default on every backend but its TPU.
    Whether the card should default to on is left to measurement."""
    env = os.environ.get('REGDA_DEVICE_DATA')
    if env is not None:
        return env not in ('0', 'false', 'False')
    return bool(config.get('device_data', False))


def _budget() -> int:
    return int(os.environ.get('REGDA_DEVICE_DATA_BUDGET', DEFAULT_BUDGET))


def _device(device) -> torch.device:
    """`device` with its index ('cuda' -> 'cuda:<current>'); no CUDA device
    for a CUDA request raises, with no move to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for device='{device}'; pass device='cpu' "
                               'to cache the split on the CPU')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device


# --------------------------------------------------------------- aug parsing

def parse_aug_spec(transforms) -> Optional[dict]:
    """Recognise the three shipped stacks; None -> not expressible on the
    device (the caller falls back to the host DALoader)."""
    if transforms is None:
        return dict(kind='none', crop=None, mean=None, std=None, clamp=False)
    if not isinstance(transforms, Compose):
        return None
    ts = list(transforms.transforms)
    spec = dict(kind='none', crop=None, mean=None, std=None, clamp=False)
    if ts and isinstance(ts[0], RandomCrop):
        th, tw = ts[0].size
        if th != tw:
            return None
        spec['crop'] = th
        ts = ts[1:]
    if not ts or not isinstance(ts[-1], Normalize):
        return None
    norm = ts[-1]
    spec['mean'] = np.asarray(norm.mean, np.float32)
    spec['std'] = np.asarray(norm.std, np.float32)
    spec['clamp'] = bool(norm.clamp)
    ts = ts[:-1]
    if not ts:
        return spec
    if (len(ts) == 1 and isinstance(ts[0], OneOf)
            and len(ts[0].transforms) == 3
            and isinstance(ts[0].transforms[0], RandomHorizontalFlip)
            and isinstance(ts[0].transforms[1], RandomVerticalFlip)
            and isinstance(ts[0].transforms[2], RandomRotate90)
            and ts[0].transforms[2].fixed_k is None
            # the chosen transform is applied unconditionally, which is the
            # host path only where every inner prob is 1 (always=True, as
            # the shipped configs build them)
            and all(t.prob == 1.0 for t in ts[0].transforms)):
        spec.update(kind='oneof', p=float(ts[0].p))
        return spec
    if (len(ts) == 3 and isinstance(ts[0], RandomHorizontalFlip)
            and isinstance(ts[1], RandomVerticalFlip)
            and isinstance(ts[2], RandomRotate90)
            and ts[2].fixed_k == 1):
        spec.update(kind='indep', hflip_p=float(ts[0].prob),
                    vflip_p=float(ts[1].prob), rot_p=float(ts[2].prob))
        return spec
    return None


# ---------------------------------------------------------------- device ops

# The 7 op codes: 0 identity, 1 hflip (W), 2 vflip (H), 3 + k rot90 by k
# (k = 0..3, np.rot90's direction over the axes (H, W)). Each maps an
# output pixel (i, j) of an S x S square to its source pixel: (a, b) =
# (j, i) where it swaps the axes, else (i, j); then row = S-1-a where it
# flips rows, else a; col = S-1-b where it flips columns, else b.
#   code       0  1  2  3  4  5  6
#   swap       .  .  .  .  x  .  x
#   flip rows  .  .  x  .  .  x  x
#   flip cols  .  x  .  .  x  x  .
HFLIP, VFLIP, ROT90 = 1, 2, 4


def _map_coords(r, c, op, s: int):
    """Source coordinates of (r, c) (each (B, S, S)) under the per-sample
    op codes `op` (B,) of an S x S square."""
    op = op.view(-1, 1, 1)
    swap = (op == 4) | (op == 6)
    flip_r = (op == 2) | (op == 5) | (op == 6)
    flip_c = (op == 1) | (op == 4) | (op == 5)
    r, c = torch.where(swap, c, r), torch.where(swap, r, c)
    return torch.where(flip_r, s - 1 - r, r), torch.where(flip_c, s - 1 - c, c)


def _geo_coords(kind: str, ops, b: int, h: int, w: int, device):
    """(B, h, w) source rows and columns of a batch's outputs: the identity
    map, or the per-sample geometric op of the `oneof` codes (B,) or of the
    `indep` flags (B, 3) (hflip, vflip, rot90 k = 1, applied in that order)."""
    r = torch.arange(h, device=device).view(1, h, 1).expand(b, h, w)
    c = torch.arange(w, device=device).view(1, 1, w).expand(b, h, w)
    if kind == 'oneof':
        r, c = _map_coords(r, c, ops, h)
    elif kind == 'indep':
        # y = rot(vflip(hflip(x))): the outermost op maps the output first
        zero = torch.zeros_like(ops[:, 0], dtype=torch.long)
        for code, flag in ((ROT90, ops[:, 2]), (VFLIP, ops[:, 1]), (HFLIP, ops[:, 0])):
            r, c = _map_coords(r, c, torch.where(flag, code, zero), h)
    return r, c


class Decisions(NamedTuple):
    """One batch's random decisions: crop offsets y, x (B,) (None: no
    crop) and the geometric ops (`oneof` codes (B,), `indep` flags (B, 3),
    or None)."""
    y: Optional[torch.Tensor]
    x: Optional[torch.Tensor]
    ops: Optional[torch.Tensor]


def _crops(spec: dict, tile_hw) -> bool:
    crop = spec['crop']
    return crop is not None and (crop < tile_hw[0] or crop < tile_hw[1])


def draw_decisions(spec: dict, tile_hw, b: int, generator: torch.Generator) -> Decisions:
    """A batch's decisions, drawn on the generator's device with the host
    stacks' distributions: crop offsets uniform on [0, h - crop] and
    [0, w - crop]; `oneof`: no op with 1 - p, else hflip, vflip or rot90
    with 1/3 each and k uniform on 0..3; `indep`: each flag with its prob."""
    dev = generator.device
    y = x = ops = None
    if _crops(spec, tile_hw):
        crop = spec['crop']
        y = torch.randint(0, tile_hw[0] - crop + 1, (b,), generator=generator, device=dev)
        x = torch.randint(0, tile_hw[1] - crop + 1, (b,), generator=generator, device=dev)
    if spec['kind'] == 'oneof':
        u = torch.rand(b, generator=generator, device=dev)
        t = torch.randint(0, 3, (b,), generator=generator, device=dev)
        k4 = torch.randint(0, 4, (b,), generator=generator, device=dev)
        # t: 0 hflip -> op 1, 1 vflip -> op 2, 2 rot90(k) -> 3 + k
        ops = torch.where(u < spec['p'], torch.where(t == 2, 3 + k4, 1 + t), 0)
    elif spec['kind'] == 'indep':
        ops = torch.stack([torch.rand(b, generator=generator, device=dev) < spec[k]
                           for k in ('hflip_p', 'vflip_p', 'rot_p')], -1)
    return Decisions(y, x, ops)


def assemble_batch(spec: dict, images, cls, sup, idx, decisions: Decisions,
                   prob_label: bool, mean=None, std=None) -> dict:
    """A batch from the cache tensors (images (N, H, W, 3) uint8; cls
    (N, H, W) int8 or (N, H, W, C) bf16, or None; sup (N, H, W) int16, or
    None), the indices `idx` (B,) on their device and the decisions: one
    gather a cache tensor, then Normalize in float32 (`mean` / `std`:
    the spec's as tensors on the device). image float32, cls float32 (soft)
    or int32, sup int32."""
    b = idx.shape[0]
    n, h, w = images.shape[:3]
    out_hw = (spec['crop'],) * 2 if decisions.y is not None else (h, w)
    r, c = _geo_coords(spec['kind'] if decisions.ops is not None else 'none',
                       decisions.ops, b, *out_hw, images.device)
    if decisions.y is not None:
        r = r + decisions.y.view(b, 1, 1)
        c = c + decisions.x.view(b, 1, 1)
    flat = (idx.view(b, 1, 1) * h + r) * w + c

    def take(a):
        return a.flatten(0, 2)[flat]

    x = take(images).float()
    if mean is not None:
        x = (x - mean) / std
        if spec['clamp']:
            x = x.clamp_max(1.0)
    out = {'image': x}
    if cls is not None:
        out['cls'] = take(cls).float() if prob_label else take(cls).int()
    if sup is not None:
        out['sup'] = take(sup).int()
    return out


def make_batch_fn(spec: dict, tile_hw, prob_label: bool, device):
    """fn(images, cls, sup, idx, generator, decisions=None) -> batch: draws
    the decisions (unless given) and assembles the batch on `device`."""
    mean = std = None
    if spec['mean'] is not None:
        mean = torch.as_tensor(spec['mean'], device=device)
        std = torch.as_tensor(spec['std'], device=device)

    def fn(images, cls, sup, idx, generator, decisions: Optional[Decisions] = None):
        if decisions is None:
            decisions = draw_decisions(spec, tile_hw, idx.shape[0], generator)
        return assemble_batch(spec, images, cls, sup, idx, decisions, prob_label, mean, std)

    return fn


def _index_tensor(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """The batch's indices on `device`; to the card from pinned memory,
    without waiting for the work queued before."""
    t = torch.from_numpy(idx)
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# -------------------------------------------------------------------- loader

class DeviceCacheTooLarge(Exception):
    """The split's cache would exceed REGDA_DEVICE_DATA_BUDGET."""


class DeviceLoader:
    """In place of DALoader on training splits: the same iteration protocol
    (per-epoch shuffle by `np.random.default_rng(seed + epoch)`, drop_last
    when training, CV subsets, `__len__`), so the same index order, but
    batches are tensors assembled on `device`. Raises ValueError where the
    transforms are not expressible on the device or the crop exceeds the
    tile, DeviceCacheTooLarge over the budget, and AssertionError where a
    region id does not fit the int16 cache."""

    def __init__(self, config: dict, dataset_name: str, seed: int = 2333,
                 budget_bytes: Optional[int] = None, device='cuda'):
        self.device = _device(device)
        self.dataset = TileDataset(
            dataset_name,
            image_dir=config['image_dir'],
            mask_dir=config.get('mask_dir'),
            transforms=None,
            label_type=config.get('label_type', 'id'),
            read_sup=config.get('read_sup', False),
        )
        spec = parse_aug_spec(config.get('transforms'))
        if spec is None:
            raise ValueError('transforms not expressible on the device')
        self.spec = spec
        self.batch_size = config.get('batch_size', 1)
        self.training = config.get('training', False)
        self.drop_last = True if self.training else False
        self.seed = seed
        self._epoch = 0
        self._cv_subset = DALoader.compute_cv_subset(
            len(self.dataset), config.get('CV'), self.training, seed)
        self.uploaded_bytes = 0     # the batches' indices sent to the device

        prob = self.dataset.label_type == 'prob'
        imgs, clss, sups, fnames = [], [], [], []
        for i in range(len(self.dataset)):
            s = self.dataset.read_raw(i)
            fnames.append(s['fname'])
            imgs.append(s['image'])
            if 'cls' in s:
                clss.append(s['cls'].astype(np.float16) if prob else s['cls'].astype(np.int8))
            if 'sup' in s:
                if s['sup'].max() >= 32767:
                    raise AssertionError('region id exceeds the int16 cache')
                sups.append(s['sup'].astype(np.int16))
        imgs = np.stack(imgs)
        if imgs.dtype != np.uint8:
            raise AssertionError(f'images of dtype {imgs.dtype}, not uint8')
        self.fnames = fnames
        self.tile_hw = imgs.shape[1:3]
        crop = spec['crop']
        if crop is not None and (crop > self.tile_hw[0] or crop > self.tile_hw[1]):
            # the host RandomCrop fails on this config: surface it rather
            # than train uncropped at the tile's size
            raise ValueError(f'crop {crop} exceeds cached tile {self.tile_hw}')
        out_hw = (crop, crop) if _crops(spec, self.tile_hw) else self.tile_hw
        if spec['kind'] != 'none' and out_hw[0] != out_hw[1]:
            raise ValueError(f'flips and rot90 need square crops, not {out_hw}')

        budget = budget_bytes if budget_bytes is not None else _budget()
        self.nbytes = imgs.nbytes + sum(a.nbytes for a in clss) + sum(a.nbytes for a in sups)
        if self.nbytes > budget:
            raise DeviceCacheTooLarge(f'{self.nbytes} > {budget} bytes')

        dev = self.device
        self._images = torch.from_numpy(imgs).to(dev)
        self._cls = None
        if clss:
            # soft labels: float16 from disk, bf16 on the device (the JAX
            # package's two roundings)
            self._cls = torch.from_numpy(np.stack(clss)).to(dev)
            if prob:
                self._cls = self._cls.to(torch.bfloat16)
        self._sup = torch.from_numpy(np.stack(sups)).to(dev) if sups else None
        self._fn = make_batch_fn(spec, self.tile_hw, prob, dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    # -- DALoader-compatible sizing and iteration ----------------------------
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

    def sample(self, idx, decisions: Optional[Decisions] = None) -> dict:
        """The batch of the tiles `idx`, with drawn decisions unless given."""
        idx = np.asarray(idx, np.int64)
        if idx.size and not 0 <= idx.min() <= idx.max() < len(self.fnames):
            raise IndexError(f'tile indices {idx} outside the {len(self.fnames)} cached')
        t = _index_tensor(idx, self.device)
        self.uploaded_bytes += t.nbytes
        out = self._fn(self._images, self._cls, self._sup, t, self.generator, decisions)
        out['fname'] = [self.fnames[int(i)] for i in idx]
        return out

    def __iter__(self):
        idx = self._epoch_indices()
        for b in range(len(self)):
            lo = b * self.batch_size
            yield self.sample(idx[lo:lo + self.batch_size])


# --------------------------------------------------------------- eval cache

_EVAL_CACHE: dict = {}


class DeviceEvalSet:
    """A sequential eval split resident on `device` as uint8, each batch
    normalised there. Labels stay on the host as numpy (the confusion
    matrix is a host op), read from disk once and kept. `get_eval_set`
    keeps one per split for the process, so repeated evals upload it once.

    The same CV fold as DALoader (sorted), and the same budget as
    DeviceLoader: an over-budget split raises DeviceCacheTooLarge, so the
    caller can fall back to the host loader."""

    def __init__(self, config: dict, dataset_name: str, seed: int = 2333, device='cuda'):
        self.device = _device(device)
        ds = TileDataset(dataset_name,
                         image_dir=config['image_dir'],
                         mask_dir=config.get('mask_dir'),
                         transforms=None,
                         label_type='id',
                         read_sup=config.get('read_sup', False))
        spec = parse_aug_spec(config.get('transforms'))
        if spec is None or spec['kind'] != 'none' or spec['crop'] is not None:
            raise ValueError('eval transforms must be Normalize-only')
        self.ds = ds
        subset = DALoader.compute_cv_subset(
            len(ds), config.get('CV'), bool(config.get('training', False)), seed)
        self._indices = np.sort(subset) if subset is not None else np.arange(len(ds))
        imgs = np.stack([read_image(ds.rgb_paths[i]) for i in self._indices])
        if imgs.dtype != np.uint8:
            raise AssertionError(f'images of dtype {imgs.dtype}, not uint8')
        budget = _budget()
        self.nbytes = imgs.nbytes
        if self.nbytes > budget:
            raise DeviceCacheTooLarge(f'{self.nbytes} > {budget} bytes')
        self._images = torch.from_numpy(imgs).to(self.device)
        self._mean = self._std = None
        if spec['mean'] is not None:
            self._mean = torch.as_tensor(spec['mean'], device=self.device)
            self._std = torch.as_tensor(spec['std'], device=self.device)
        self._clamp = spec['clamp']
        self.batch_size = config.get('batch_size', 1)
        self._cls_cache: Optional[list] = None

    def _norm(self, u8: torch.Tensor) -> torch.Tensor:
        x = u8.float()
        if self._mean is None:
            return x
        x = (x - self._mean) / self._std
        return x.clamp_max(1.0) if self._clamp else x

    def _cls(self, i: int) -> np.ndarray:
        if self._cls_cache is None:
            self._cls_cache = [self.ds.read_raw(int(j))['cls'] for j in self._indices]
        return self._cls_cache[i]

    def __iter__(self):
        n = len(self._indices)
        bs = self.batch_size
        for lo in range(0, n, bs):
            sel = range(lo, min(lo + bs, n))
            out = {'image': self._norm(self._images[lo:lo + len(sel)]),
                   'fname': [os.path.basename(self.ds.rgb_paths[int(self._indices[i])])
                             for i in sel]}
            if self.ds.cls_paths:
                out['cls'] = np.stack([self._cls(i) for i in sel])
            yield out

    def __len__(self):
        return -(-len(self._indices) // self.batch_size)


def get_eval_set(config: dict, dataset_name: str, device='cuda') -> DeviceEvalSet:
    """The process's DeviceEvalSet of this split on `device`, built once.
    The key covers everything the set bakes in (directories, dataset,
    read_sup, batch size, Normalize's mean, std and clamp, the CV fold,
    the device), so two configs that share directories never share a
    normalisation."""
    device = _device(device)
    spec = parse_aug_spec(config.get('transforms'))
    norm_key = (None if spec is None or spec['mean'] is None else
                (tuple(np.ravel(spec['mean']).tolist()),
                 tuple(np.ravel(spec['std']).tolist()), spec['clamp']))
    cv = config.get('CV') or {}
    key = (tuple(config['image_dir']),
           tuple(config.get('mask_dir') or ()), dataset_name,
           bool(config.get('read_sup', False)),
           config.get('batch_size', 1), norm_key,
           (int(cv.get('k', 10) or 10), int(cv.get('i', -1)),
            bool(config.get('training', False))), str(device))
    if key not in _EVAL_CACHE:
        _EVAL_CACHE[key] = DeviceEvalSet(config, dataset_name, device=device)
    return _EVAL_CACHE[key]


def eval_loader(config: dict, dataset_name: str, device='cuda', logger=None,
                what: str = 'eval'):
    """The loader of a sequential split (the eval, the pseudo-label pass):
    the process's DeviceEvalSet on `device` where `device_data_enabled
    (config)`, else DALoader. A set that cannot be built (ValueError,
    DeviceCacheTooLarge, AssertionError) logs a warning naming the reason
    and gives DALoader."""
    if device_data_enabled(config):
        try:
            return get_eval_set(config, dataset_name, device=device)
        except (ValueError, DeviceCacheTooLarge, AssertionError) as e:
            (logger or _log).warning(f'device {what} cache disabled ({e})')
    return DALoader(config, dataset_name)


def make_loader(config: dict, dataset_name: str, seed: int = 2333, logger=None,
                device='cuda'):
    """The loader of a training split: a DeviceLoader on `device` where
    `device_data_enabled(config)`, else the host DALoader. A DeviceLoader
    that cannot be built (ValueError, DeviceCacheTooLarge, AssertionError)
    logs a warning naming the reason and gives the host DALoader."""
    if device_data_enabled(config):
        try:
            loader = DeviceLoader(config, dataset_name, seed=seed, device=device)
            if logger is not None:
                logger.info(f'device-resident data: {len(loader.dataset)} tiles '
                            f'cached on {loader.device}')
            return loader
        except (ValueError, DeviceCacheTooLarge, AssertionError) as e:
            (logger or _log).warning(f'device data disabled ({e}); '
                                     'falling back to host loader')
    loader = DALoader(config, dataset_name, seed=seed)
    if logger is not None:
        native = (loader.native and loader.dataset.label_type == 'id' and native_enabled())
        logger.info(f'host loader over {len(loader.dataset)} tiles: '
                    f'{"native" if native else "Python"} decode path')
    return loader


# ------------------------------------------------------------- batch arrays

_TORCH_DTYPES = {np.dtype(t): torch.from_numpy(np.zeros(0, t)).dtype
                 for t in (np.float32, np.int32, np.int64, np.uint8)}


def astype(a, dtype):
    """`a.astype(dtype)` for a numpy batch array; for a tensor (a
    DeviceLoader's), the same cast on its device, which is the tensor
    itself where its dtype is already that."""
    if isinstance(a, torch.Tensor):
        return a.to(_TORCH_DTYPES[np.dtype(dtype)])
    return a.astype(dtype)


def batch_tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array of a batch as a tensor on `device`: a numpy array is
    uploaded (as `dtype` where one is given); a tensor, such as a
    DeviceLoader's, is taken as it is (made contiguous, which a height
    block of the spatial axis needs), with no host round trip. A tensor on
    another device, or of another dtype than `dtype`, is refused, not moved
    or cast in silence."""
    device = _device(device)
    if isinstance(a, torch.Tensor):
        if a.device != device:
            raise ValueError(f'a batch tensor on {a.device}, not on {device}: build its '
                             f'loader with device={str(device)!r}')
        if dtype is not None and a.dtype != dtype:
            raise ValueError(f'a batch tensor of {a.dtype}, not {dtype}')
        return a.contiguous()
    if dtype is not None:
        a = np.ascontiguousarray(a, torch.empty(0, dtype=dtype).numpy().dtype)
    return torch.from_numpy(a).to(device)
