"""Superpixel region maps for training tiles, the alternative to SAM
everything-mode regions (counterpart of regda_tpu/data_prep/superpixels.py;
reference: regda/gast/superpixels.py:86-126 `get_superpixels`,
regda/gast/slic/superpixel.py:160-207 `LDA_SLIC`).

The segmentation runs on the device (`ops/slic.py`: `lsc`, the reference's
algorithm, or `slic`); this module is the host-side loop that reads and
writes the tiles, and the connectivity enforcement the OpenCV pipeline
applies (`enforceLabelConnectivity`), in numpy.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
from PIL import Image

from regda_tpu_torch.entry import _device
from regda_tpu_torch.ops.slic import edge_shrink, lsc, slic


def enforce_connectivity(labels: np.ndarray, min_size: int = 25) -> np.ndarray:
    """Relabel 4-connected components and absorb those smaller than
    `min_size` into an adjacent component (OpenCV's
    `enforceLabelConnectivity(min_element_size)`, slic/superpixel.py:27).
    Returns int32 labels renumbered densely from 0, in the order of each
    component's first pixel."""
    h, w = labels.shape
    n = h * w
    lab = np.ascontiguousarray(labels)

    # connected components by min-index propagation and pointer jumping: at
    # the fixpoint every pixel holds the smallest flat index of its component
    comp = np.arange(n, dtype=np.int64).reshape(h, w)
    same_v = lab[1:, :] == lab[:-1, :]
    same_h = lab[:, 1:] == lab[:, :-1]
    while True:
        m = comp.copy()
        np.minimum(m[1:, :], np.where(same_v, comp[:-1, :], n), out=m[1:, :])
        np.minimum(m[:-1, :], np.where(same_v, comp[1:, :], n), out=m[:-1, :])
        np.minimum(m[:, 1:], np.where(same_h, comp[:, :-1], n), out=m[:, 1:])
        np.minimum(m[:, :-1], np.where(same_h, comp[:, 1:], n), out=m[:, :-1])
        m = np.minimum(m, comp.reshape(-1)[m])
        if np.array_equal(m, comp):
            break
        comp = m

    # dense ids; sorted roots are the components' first pixels in scan order
    roots, dense = np.unique(comp, return_inverse=True)
    dense = dense.reshape(h, w)
    ncomp = len(roots)
    sizes = np.bincount(dense.reshape(-1), minlength=ncomp).astype(np.int64)

    # component adjacency: deduplicated boundary pairs, both directions
    va, vb = dense[1:, :].reshape(-1), dense[:-1, :].reshape(-1)
    ha, hb = dense[:, 1:].reshape(-1), dense[:, :-1].reshape(-1)
    a = np.concatenate([va, vb, ha, hb])
    b = np.concatenate([vb, va, hb, ha])
    diff = a != b
    pair = np.unique(a[diff] * ncomp + b[diff])
    nbrs: list[list[int]] = [[] for _ in range(ncomp)]
    for x, y in zip((pair // ncomp).tolist(), (pair % ncomp).tolist()):
        nbrs[x].append(y)

    # in scan order, a component still below min_size merges into the
    # earliest neighbour that is itself still below min_size, else into the
    # earliest one; repeated to a fixpoint, since a union formed late in a
    # pass may still be small with no later member left to merge it
    parent = np.arange(ncomp, dtype=np.int64)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    changed = True
    while changed:
        changed = False
        for c in range(ncomp):
            rc = find(c)
            if sizes[rc] >= min_size:
                continue
            target = -1
            for nb in nbrs[c]:
                rn = find(nb)
                if rn == rc:
                    continue
                if target < 0:
                    target = rn
                if sizes[rn] < min_size:
                    target = rn
                    break
            if target >= 0:
                parent[rc] = target
                sizes[target] += sizes[rc]
                changed = True

    merged = np.array([find(i) for i in range(ncomp)], dtype=np.int64)
    _, out = np.unique(merged[dense], return_inverse=True)
    return out.reshape(h, w).astype(np.int32)


def boundary_vis(image: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """The image with superpixel boundaries painted green (superpixels.py:
    73-81)."""
    edge = np.zeros(labels.shape, bool)
    edge[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    edge[1:, :] |= labels[1:, :] != labels[:-1, :]
    out = image.copy()
    out[edge] = (0, 255, 0)
    return out


def _save(array: np.ndarray, path: str) -> None:
    Image.fromarray(np.ascontiguousarray(array)).save(path)


def superpixel_labels(image: np.ndarray, device, method: str = 'lsc', region_size: int = 16,
                      compactness: float = 10.0, iterations: int = 10, ratio: float = 0.075,
                      min_element_size: int = 25) -> np.ndarray:
    """One uint8 (H, W, 3) tile -> its (H, W) int32 superpixel labels: LSC
    on `device` then connectivity on the host, or SLIC on `device`."""
    x = torch.from_numpy(np.array(image)).to(device).float() / 255.0
    if method == 'lsc':
        labels = lsc(x, region_size=region_size, ratio=ratio, iterations=iterations)
        return enforce_connectivity(labels.cpu().numpy(), min_element_size)
    return slic(x, region_size=region_size, compactness=compactness,
                iterations=iterations).cpu().numpy()


def get_superpixels(dir_path: str, out_dir: str, postfix: str = 'png',
                    region_size: int = 16, compactness: float = 10.0,
                    iterations: int = 10, shrinking: bool = True,
                    win_size: int = 3, method: str = 'lsc',
                    ratio: float = 0.075, min_element_size: int = 25,
                    device='cuda') -> int:
    """Superpixel label maps of every `*.{postfix}` tile in `dir_path` ->
    `{out_dir}/<name>.tif` (int32), with `{out_dir}_vis`, and, with
    `shrinking`, `{out_dir}_shrink` and `{out_dir}_shrink_vis` beside it
    (superpixels.py:86-126). `method='lsc'` (default) is the reference's
    `SuperPixelsLSC` (region_size 16, ratio 0.075), `'slic'` SLIC with
    `compactness`. The segmentation runs on `device`, the card unless the
    caller names another; -> the number of tiles."""
    device = _device(device)
    img_paths = sorted(glob.glob(os.path.join(dir_path, f'*.{postfix}')))
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(out_dir + '_vis', exist_ok=True)
    if shrinking:
        os.makedirs(out_dir + '_shrink', exist_ok=True)
        os.makedirs(out_dir + '_shrink_vis', exist_ok=True)

    for img_path in img_paths:
        with Image.open(img_path) as im:
            img = np.asarray(im)[..., :3]
        labels = superpixel_labels(img, device, method, region_size, compactness, iterations,
                                   ratio, min_element_size)
        name = os.path.basename(img_path).replace(f'.{postfix}', '.tif')
        _save(labels.astype(np.int32), os.path.join(out_dir, name))
        _save(boundary_vis(img, labels), os.path.join(out_dir + '_vis',
                                                      os.path.basename(img_path)))
        if shrinking:
            # the reference's fill is the superpixel count (cnt_sup): the
            # grid's for SLIC, the count after connectivity for LSC
            n_sup = (int(labels.max()) + 1 if method == 'lsc' else
                     (img.shape[0] // region_size) * (img.shape[1] // region_size))
            shrunk = edge_shrink(torch.from_numpy(labels), win_size=win_size,
                                 fill=n_sup).numpy()
            _save(shrunk.astype(np.int32), os.path.join(out_dir + '_shrink', name))
            _save(boundary_vis(img, shrunk), os.path.join(out_dir + '_shrink_vis',
                                                          os.path.basename(img_path)))
    return len(img_paths)


def lda_project(data: np.ndarray, labels: np.ndarray, n_components: int) -> np.ndarray:
    """Fisher LDA projection in closed form, in place of the reference's
    sklearn LinearDiscriminantAnalysis (slic/superpixel.py:171-183).
    data (N, D), labels (N,) (< 0 ignored) -> (N, n_components) float32,
    min-max scaled to [0, 1] as the reference's preprocessing.minmax_scale."""
    valid = labels >= 0
    x, y = data[valid].astype(np.float64), labels[valid]
    mean = x.mean(0)
    d = x.shape[1]
    sw = np.zeros((d, d))
    sb = np.zeros((d, d))
    for c in np.unique(y):
        xc = x[y == c]
        mc = xc.mean(0)
        sw += (xc - mc).T @ (xc - mc)
        diff = (mc - mean)[:, None]
        sb += len(xc) * (diff @ diff.T)
    evals, evecs = np.linalg.eig(np.linalg.pinv(sw) @ sb)
    order = np.argsort(-evals.real)
    w = evecs[:, order[:n_components]].real
    proj = data.astype(np.float64) @ w
    lo, hi = proj.min(0), proj.max(0)
    return ((proj - lo) / np.maximum(hi - lo, 1e-12)).astype(np.float32)


def lda_slic(image: np.ndarray, labels: np.ndarray, n_components: int = 3,
             region_size: int = 16, compactness: float = 10.0,
             iterations: int = 10, device='cuda') -> np.ndarray:
    """`LDA_SLIC.simple_superpixel` (slic/superpixel.py:194-198): project
    the pixels by LDA supervised by (pseudo-)labels, then SLIC the
    projection on `device`. image (H, W, D) float, labels (H, W) int ->
    (H, W) int32."""
    device = _device(device)
    h, w = labels.shape
    proj = lda_project(image.reshape(h * w, -1), labels.reshape(-1),
                       n_components).reshape(h, w, n_components)
    if n_components < 3:   # SLIC takes 3 channels: repeat
        proj = np.concatenate([proj] * 3, axis=-1)[..., :3]
    return slic(torch.from_numpy(np.ascontiguousarray(proj)).to(device),
                region_size=region_size, compactness=compactness,
                iterations=iterations).cpu().numpy()
