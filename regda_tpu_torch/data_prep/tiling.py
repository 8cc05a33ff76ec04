"""ISPRS Potsdam/Vaihingen orthophoto tilers (counterpart of
regda_tpu/data_prep/tiling.py; reference: convert_datasets/
convert_potsdam.py:35-178, convert_potsdam_rgb.py:46,
convert_vaihingen.py:34-201).

The reference's behaviours are kept:
  * the tile grid is non-overlapping clip_size boxes on a (rows+1, cols+1)
    lattice whose out-of-range boxes snap back to the image edge, so edge
    tiles repeat interior pixels; identical snapped boxes are one tile;
  * Potsdam label colour -> id by a base-(2, 3, 4) dot product over the
    palette, unmatched pixels 0; Vaihingen's unmatched pixels 5; clutter (6)
    merged into 0 for both;
  * Potsdam scenes 6_7 and 4_12 are dropped; fixed train/val/test splits;
  * names `{i}_{j}_{x0}_{y0}_{x1}_{y1}.png` (Potsdam) and
    `{area}_{x0}_{y0}_{x1}_{y1}.png` (Vaihingen).

Rasters are read and tiles written with PIL. A 4-band RGBIR TIFF is taken
as stored, in whatever 4-channel mode PIL opens it (RGBA, RGBX, CMYK), and
never converted; a 4th band tagged as associated alpha is read raw
(`read_raster`), so the array holds the file's channels as imageio gives
them. Colour math is in natural RGB channel order.
"""

from __future__ import annotations

import glob
import math
import os
import tempfile
import zipfile
from dataclasses import dataclass

import numpy as np
from PIL import Image

# ISPRS semantic palette in RGB; index = class id after conversion.
# (ignore/clutter, impervious surface, building, low vegetation, tree, car)
ISPRS_PALETTE_RGB = np.array([
    [0, 0, 0],          # 0 ignore / background
    [255, 255, 255],    # 1 impervious surface
    [0, 0, 255],        # 2 building
    [0, 255, 255],      # 3 low vegetation
    [0, 255, 0],        # 4 tree
    [255, 255, 0],      # 5 car
    [255, 0, 0],        # 6 clutter -> merged into 0
], np.int64)

POTSDAM_SPLITS = {
    'train': ['2_10', '3_10', '3_11', '3_12', '4_11', '4_12', '5_10', '5_12',
              '6_10', '6_11', '6_12', '6_8', '6_9', '7_11', '7_12', '7_7', '7_9'],
    'val': ['2_11', '2_12', '4_10', '5_11', '6_7', '7_10', '7_8'],
    'test': ['5_15', '6_15', '6_13', '3_13', '4_14', '6_14', '5_14', '2_13',
             '4_15', '2_14', '5_13', '4_13', '3_14', '7_13'],
}
POTSDAM_DROPPED = ('6_7', '4_12')   # convert_potsdam.py:154-156

VAIHINGEN_SPLITS = {
    'train': ['area1', 'area13', 'area17', 'area21', 'area23', 'area26',
              'area3', 'area32', 'area37', 'area5', 'area7'],
    'val': ['area11', 'area15', 'area28', 'area30', 'area34'],
    'test': ['area6', 'area24', 'area35', 'area16', 'area14', 'area22',
             'area10', 'area4', 'area2', 'area20', 'area8', 'area31',
             'area33', 'area27', 'area38', 'area12', 'area29'],
}


def _raw_rgba(tile):
    """A decoder tile of PIL's whose rawmode says 'RGBa' (the 4th band is an
    associated alpha: PIL would divide the colour bands by it) set to read
    the stored bytes as they are."""
    args = ('RGBA',) + tuple(tile[3][1:])
    return tile._replace(args=args) if hasattr(tile, '_replace') else (*tile[:3], args)


def read_raster(path: str) -> np.ndarray:
    """The raster's stored channels: (H, W) or (H, W, C). A 4-band TIFF
    whose 4th band is tagged as associated alpha (ExtraSamples = 1, as
    tifffile writes one) opens in PIL as RGBA un-premultiplied from the
    stored bytes; it is read raw here, as an RGBIR raster must be."""
    with Image.open(path) as im:
        if im.mode == 'RGBA' and any(t[3] and t[3][0] == 'RGBa' for t in im.tile):
            im.tile = [_raw_rgba(t) if t[3] and t[3][0] == 'RGBa' else t for t in im.tile]
        return np.asarray(im)


def tile_boxes(h: int, w: int, clip: int) -> np.ndarray:
    """Edge-snapped non-overlapping boxes, (N, 4) [x0, y0, x1, y1], sorted
    and without duplicates (convert_potsdam.py:54-77)."""
    rows = max(math.ceil((h - clip) / clip) + 1, 1) + 1
    cols = max(math.ceil((w - clip) / clip) + 1, 1) + 1
    xs, ys = np.meshgrid(np.arange(cols) * clip, np.arange(rows) * clip)
    x0 = xs.ravel()
    y0 = ys.ravel()
    x0 = np.where(x0 + clip > w, w - clip, x0)
    y0 = np.where(y0 + clip > h, h - clip, y0)
    boxes = np.stack([x0, y0, np.minimum(x0 + clip, w), np.minimum(y0 + clip, h)], axis=1)
    return np.unique(boxes, axis=0)


def rgb_label_to_ids(label_rgb: np.ndarray, unmatched: int = 0) -> np.ndarray:
    """Palette RGB label raster -> uint8 class ids, clutter merged into 0.
    The (2, 3, 4) base encoding gives each palette colour one scalar key."""
    basis = np.array([2, 3, 4], np.int64)
    keys = label_rgb.astype(np.int64) @ basis
    out = np.full(keys.shape, unmatched, np.uint8)
    for idx, color in enumerate(ISPRS_PALETTE_RGB):
        out[keys == color @ basis] = idx
    out[out == 6] = 0
    return out


def emit_tiles(raster: np.ndarray, clip: int, name_fn, save_dir: str,
               is_label: bool) -> int:
    """Write every `tile_boxes` crop of `raster` as a uint8 PNG named by
    `name_fn(x0, y0, x1, y1)`; -> the number of tiles. `is_label` is the
    reference's argument, kept for its callers: labels and images are
    written alike."""
    os.makedirs(save_dir, exist_ok=True)
    n = 0
    for x0, y0, x1, y1 in tile_boxes(*raster.shape[:2], clip):
        tile = np.ascontiguousarray(raster[y0:y1, x0:x1].astype(np.uint8))
        Image.fromarray(tile).save(os.path.join(save_dir, name_fn(x0, y0, x1, y1)))
        n += 1
    return n


@dataclass
class TilerConfig:
    out_dir: str
    clip_size: int = 512
    rgb: bool = False       # Potsdam only: RGB channel select instead of IRRG


def _split_of(key: str, splits: dict) -> str:
    if key in splits['train']:
        return 'train'
    if key in splits['val']:
        return 'val'
    return 'test'


def convert_potsdam_scene(img_path: str, cfg: TilerConfig) -> int:
    """One Potsdam .tif (RGBIR image or RGB label) -> its tiles; 0 for a
    dropped scene."""
    base = os.path.basename(img_path)
    idx_i, idx_j = base.split('_')[2:4]
    key = f'{idx_i}_{idx_j}'
    if key in POTSDAM_DROPPED:
        return 0
    split = _split_of(key, POTSDAM_SPLITS)

    def name_fn(x0, y0, x1, y1):
        return f'{idx_i}_{idx_j}_{x0}_{y0}_{x1}_{y1}.png'

    if 'label' in base:
        ids = rgb_label_to_ids(read_raster(img_path)[..., :3], unmatched=0)
        return emit_tiles(ids, cfg.clip_size, name_fn,
                          os.path.join(cfg.out_dir, 'ann_dir', split), is_label=True)
    channels = [0, 1, 2] if cfg.rgb else [3, 0, 1]   # IRRG: IR-Red-Green
    img = read_raster(img_path)[..., channels]
    return emit_tiles(img, cfg.clip_size, name_fn,
                      os.path.join(cfg.out_dir, 'img_dir', split), is_label=False)


def convert_vaihingen_scene(img_path: str, cfg: TilerConfig, is_label: bool) -> int:
    """One Vaihingen .tif (IRRG image, passed through, or RGB label) -> its
    tiles."""
    base = os.path.basename(img_path)
    area = base.split('_')[3].split('.')[0]           # top_mosaic_09cm_areaN
    split = _split_of(area, VAIHINGEN_SPLITS)

    def name_fn(x0, y0, x1, y1):
        return f'{area}_{x0}_{y0}_{x1}_{y1}.png'

    if is_label:
        ids = rgb_label_to_ids(read_raster(img_path)[..., :3], unmatched=5)
        return emit_tiles(ids, cfg.clip_size, name_fn,
                          os.path.join(cfg.out_dir, 'ann_dir', split), True)
    img = read_raster(img_path)[..., :3]               # already IRRG on disk
    return emit_tiles(img, cfg.clip_size, name_fn,
                      os.path.join(cfg.out_dir, 'img_dir', split), False)


def iter_source_rasters(dataset_path: str, pattern: str = '*.tif'):
    """Yield raster paths from a directory of .tifs and/or .zips of .tifs
    (each zip unpacked into a temporary directory while its rasters are
    used)."""
    yield from sorted(glob.glob(os.path.join(dataset_path, pattern)))
    for z in sorted(glob.glob(os.path.join(dataset_path, '*.zip')), reverse=True):
        with tempfile.TemporaryDirectory() as tmp:
            with zipfile.ZipFile(z) as zf:
                zf.extractall(tmp)
            found = glob.glob(os.path.join(tmp, pattern))
            if not found:
                sub = os.path.join(tmp, sorted(os.listdir(tmp))[0])
                found = glob.glob(os.path.join(sub, pattern))
            yield from sorted(found)
