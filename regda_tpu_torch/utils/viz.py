"""Palette-PNG prediction dumps (counterpart of regda_tpu/utils/viz.py;
parity: regda/viz.py:11-28). PIL is imported where an image is written."""

from __future__ import annotations

import os

import numpy as np


class VisualizeSegmm:
    def __init__(self, out_dir: str, palette):
        self.out_dir = out_dir
        self.palette = list(palette)
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, y_pred: np.ndarray, filename: str):
        from PIL import Image
        y = np.asarray(y_pred).astype(np.uint8).squeeze()
        img = Image.fromarray(y, mode='P')
        img.putpalette(self.palette)
        img.save(os.path.join(self.out_dir, filename))
