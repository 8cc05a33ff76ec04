"""Host-side tile dataset: file listing + sample reading (numpy HWC).

The port's copy of regda_tpu/datasets/basedata.py.

Parity target: regda/datasets/basedata.py:28-118 (`BaseData`): globs
*.tif/*.png under img_dir(s); the mask path is the same fname under
mask_dir; the SAM region path swaps img_dir->reg_dir with a .tif suffix;
label_type 'id' reads uint8 ids (+offset, >=n_classes -> ignore) and 'prob'
reads per-tile probability arrays saved by pseudo-generation (we store
float32 .npy instead of torch .pt).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from regda_tpu_torch.datasets.meta import DatasetMeta, get_meta


def read_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path))


class TileDataset:
    def __init__(self, meta: DatasetMeta | str,
                 image_dir: Sequence[str] | str,
                 mask_dir: Sequence[str] | str | None,
                 transforms=None, label_type: str = 'id',
                 read_sup: bool = False):
        assert label_type in ('id', 'prob')
        self.meta = get_meta(meta) if isinstance(meta, str) else meta
        self.label_type = label_type
        self.read_sup = read_sup
        self.transforms = transforms
        self.rgb_paths: list[str] = []
        self.cls_paths: list[str] = []
        self.sup_paths: list[str] = []

        image_dirs = [image_dir] if isinstance(image_dir, str) else list(image_dir)
        mask_dirs = ([mask_dir] if isinstance(mask_dir, str) or mask_dir is None
                     else list(mask_dir))
        if len(mask_dirs) == 1 and len(image_dirs) > 1:
            mask_dirs = mask_dirs * len(image_dirs)
        for img_d, msk_d in zip(image_dirs, mask_dirs):
            self._scan(img_d, msk_d)

    def _scan(self, image_dir: str, mask_dir: Optional[str]):
        rgb = sorted(glob.glob(os.path.join(image_dir, '*.tif'))
                     + glob.glob(os.path.join(image_dir, '*.png')))
        for fp in rgb:
            fname = os.path.basename(fp)
            self.rgb_paths.append(fp)
            if mask_dir is not None:
                self.cls_paths.append(os.path.join(mask_dir, fname))
            self.sup_paths.append(os.path.join(
                image_dir.replace('img_dir', 'reg_dir'),
                f"{fname.split('.')[0]}.tif"))

    def __len__(self):
        return len(self.rgb_paths)

    def read_raw(self, idx: int) -> dict:
        """Untransformed sample with compact dtypes (image stays uint8)."""
        sample = {'fname': os.path.basename(self.rgb_paths[idx])}
        sample['image'] = read_image(self.rgb_paths[idx])

        if self.read_sup:
            sample['sup'] = np.asarray(
                Image.open(self.sup_paths[idx])).astype(np.int32)

        if self.cls_paths:
            if self.label_type == 'id':
                mask = read_image(self.cls_paths[idx]).astype(np.int64)
                mask = mask + self.meta.offset
                mask[mask >= self.meta.num_classes] = self.meta.ignore_label
                sample['cls'] = mask.astype(np.int32)
            else:
                # probability pseudo-label saved by gener_target_pseudo: (H,W,C)
                prob = np.load(f'{self.cls_paths[idx]}.npy')
                sample['cls'] = prob.astype(np.float32)
        return sample

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        sample = self.read_raw(idx)
        sample['image'] = sample['image'].astype(np.float32)

        if self.transforms is not None:
            sample = self.transforms(sample, rng or np.random.default_rng())
        return sample
