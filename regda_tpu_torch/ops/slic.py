"""SLIC and LSC superpixels on torch tensors (counterpart of
regda_tpu/ops/slic.py; reference: regda/gast/superpixels.py:49-152,
regda/gast/slic/superpixel.py:66-158).

Both are k-means over per-pixel features with a locality constraint: each
pixel considers exactly the 9 clusters of its 3x3 grid neighbourhood (a
static candidate set), so one iteration is: gather 9 centres -> distance
argmin -> per-cluster sums (`index_add_`). They run on the device of the
image they are given; the JAX package's versions are XLA's segment sums,
and these are PyTorch's.

A card's atomic float adds are not ordered, so a centre's mean can differ
from the CPU's (and from JAX's) in its last bit, and after some iterations
a pixel whose two nearest centres are almost tied can take the other one.
Images whose segments are unambiguous give identical labels everywhere.
Label connectivity is not enforced here
(`data_prep.superpixels.enforce_connectivity` does it on the host).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_RGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
               (0.2126729, 0.7151522, 0.0721750),
               (0.0193339, 0.1191920, 0.9503041))
_D65_WHITE = (0.95047, 1.0, 1.08883)
_DY = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_DX = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> CIELAB (D65)."""
    rgb = rgb.clamp(0.0, 1.0)
    lin = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    m = torch.tensor(_RGB_TO_XYZ, dtype=rgb.dtype, device=rgb.device)
    t = (lin @ m.T) / torch.tensor(_D65_WHITE, dtype=rgb.dtype, device=rgb.device)
    f = torch.where(t > (6 / 29) ** 3, t.clamp(min=0.0) ** (1.0 / 3.0),
                    t / (3 * (6 / 29) ** 2) + 4 / 29)
    l = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def _grid(h: int, w: int, s: int, dtype, device):
    """Pixel coordinates (ys, xs) in `dtype`, and each pixel's 9 candidate
    cluster ids (H, W, 9) with their in-grid mask."""
    gh, gw = h // s, w // s
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing='ij')
    gy = ys[..., None] // s + torch.tensor(_DY, device=device)
    gx = xs[..., None] // s + torch.tensor(_DX, device=device)
    in_grid = (gy >= 0) & (gy < gh) & (gx >= 0) & (gx < gw)
    cand = gy.clamp(0, gh - 1) * gw + gx.clamp(0, gw - 1)
    return ys.to(dtype), xs.to(dtype), cand, in_grid


def _assign(centers, feats, cand, in_grid):
    """Each pixel's nearest candidate centre (the first on a tie), (H, W)."""
    d = ((centers[cand] - feats[:, :, None, :]) ** 2).sum(-1)
    d = d.masked_fill(~in_grid, math.inf)
    return torch.gather(cand, -1, d.argmin(-1, keepdim=True))[..., 0]


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


def _check_grid(h: int, w: int, s: int) -> None:
    if h % s or w % s:
        raise ValueError(f'image {h}x{w} is not a multiple of region_size {s}')


def slic(image: torch.Tensor, region_size: int = 16, compactness: float = 10.0,
         iterations: int = 10) -> torch.Tensor:
    """SLIC labels for one (H, W, 3) image in [0, 1] (H, W multiples of
    region_size) -> (H, W) int32 labels in [0, (H/S)*(W/S)), on the image's
    device."""
    h, w, _ = image.shape
    s = region_size
    _check_grid(h, w, s)
    gh, gw = h // s, w // s
    n_sup = gh * gw
    ys, xs, cand, in_grid = _grid(h, w, s, image.dtype, image.device)
    scale = compactness / s
    # (l, a, b, m/S * x, m/S * y): the compactness folds into the features
    feats = torch.cat([srgb_to_lab(image), (xs * scale)[..., None], (ys * scale)[..., None]],
                      dim=-1)
    centers = feats.reshape(gh, s, gw, s, 5).mean(dim=(1, 3)).reshape(n_sup, 5)
    flat_feats = feats.reshape(-1, 5)
    ones = torch.ones((h * w, 1), dtype=feats.dtype, device=feats.device)
    for _ in range(iterations):
        flat = _assign(centers, feats, cand, in_grid).reshape(-1)
        sums = _segment_sum(flat_feats, flat, n_sup)
        cnts = _segment_sum(ones, flat, n_sup)
        centers = torch.where(cnts > 0, sums / cnts.clamp(min=1.0), centers)
    return _assign(centers, feats, cand, in_grid).to(torch.int32)


def lsc(image: torch.Tensor, region_size: int = 16, ratio: float = 0.075,
        iterations: int = 20) -> torch.Tensor:
    """LSC (Linear Spectral Clustering) labels for one (H, W, 3) image in
    [0, 1]: the algorithm the reference runs
    (`cv2.ximgproc.createSuperpixelLSC(img, region_size=16, ratio=0.075)`,
    regda/gast/superpixels.py:67), as the JAX package's `lsc` formulates it:
    weighted k-means over the 10-D kernel features phi(p) (cosines and sines
    of the colour and position angles, a/b boosted by 2.55, positions scaled
    by `ratio` * extent / region_size), pixel weight w(p) = phi(p) . mean(phi),
    distances on phi(p) / w(p), centres the w-weighted means. Returns (H, W)
    int32 labels in [0, (H/S)*(W/S)), on the image's device."""
    h, w, _ = image.shape
    s = region_size
    _check_grid(h, w, s)
    gh, gw = h // s, w // s
    n_sup = gh * gw
    half_pi = math.pi / 2
    dt, dev = image.dtype, image.device
    lab = srgb_to_lab(image)
    # OpenCV feeds LSC 8-bit Lab: its [0, 1] normalisation
    lab01 = torch.stack([lab[..., 0] / 100.0, (lab[..., 1] + 128.0) / 255.0,
                         (lab[..., 2] + 128.0) / 255.0], dim=-1)
    theta_c = lab01.clamp(0.0, 1.0) * half_pi
    cw = torch.tensor([1.0, 2.55, 2.55], dtype=dt, device=dev)
    color = torch.cat([cw * torch.cos(theta_c), cw * torch.sin(theta_c)], dim=-1)
    ys, xs, cand, in_grid = _grid(h, w, s, dt, dev)
    theta_x = xs * (half_pi / max(w - 1, 1))
    theta_y = ys * (half_pi / max(h - 1, 1))
    cs_x = ratio * (w - 1) / s
    cs_y = ratio * (h - 1) / s
    spatial = torch.stack([cs_x * torch.cos(theta_x), cs_x * torch.sin(theta_x),
                           cs_y * torch.cos(theta_y), cs_y * torch.sin(theta_y)], dim=-1)
    phi = torch.cat([color, spatial], dim=-1)                         # (H, W, 10)
    wgt = phi @ phi.mean(dim=(0, 1))        # > 0: every component of phi is >= 0
    phin = phi / wgt[..., None]
    # sum_p w_p (phi_p / w_p) / sum_p w_p = sum(phi) / sum(w)
    wphi = phi.reshape(gh, s, gw, s, 10).sum(dim=(1, 3))
    wsum = wgt.reshape(gh, s, gw, s).sum(dim=(1, 3))
    centers = (wphi / wsum[..., None]).reshape(n_sup, 10)
    flat_phi, flat_w = phi.reshape(-1, 10), wgt.reshape(-1, 1)
    for _ in range(iterations):
        flat = _assign(centers, phin, cand, in_grid).reshape(-1)
        sums = _segment_sum(flat_phi, flat, n_sup)
        wsums = _segment_sum(flat_w, flat, n_sup)
        centers = torch.where(wsums > 0, sums / wsums.clamp(min=1e-12), centers)
    return _assign(centers, phin, cand, in_grid).to(torch.int32)


def edge_shrink(labels: torch.Tensor, win_size: int = 3, fill: int | None = None) -> torch.Tensor:
    """Mark pixels within `win_size` of a superpixel boundary as invalid
    (regda/gast/superpixels.py:129-152 `edge_shrinking`): a pixel keeps its
    label iff its (2w+1)^2 window, cut at the image's edge, holds one label;
    the others get `fill` (default: the largest label + 1, the reference's
    `cnt_sup`). (H, W) int -> (H, W) int32."""
    k = 2 * win_size + 1
    lab = labels.to(torch.int32)
    # float64 holds every int32 exactly; max_pool pads with -inf
    x = lab.to(torch.float64)[None, None]
    mx = F.max_pool2d(x, k, 1, win_size)[0, 0]
    mn = -F.max_pool2d(-x, k, 1, win_size)[0, 0]
    fill_val = int(lab.max()) + 1 if fill is None else int(fill)
    return torch.where(mx == mn, lab, torch.full_like(lab, fill_val))


def superpixel_stats(labels: torch.Tensor, feats: torch.Tensor,
                     n_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean feature per superpixel and pixel counts (the reference's S and
    the column sums of Q, gast/slic/superpixel.py:83-131):
    -> (S (n_segments, K), counts (n_segments,))."""
    flat = labels.reshape(-1).long()
    f = feats.reshape(-1, feats.shape[-1])
    sums = _segment_sum(f, flat, n_segments)
    cnts = _segment_sum(torch.ones_like(flat, dtype=f.dtype), flat, n_segments)
    return sums / cnts.clamp(min=1.0)[:, None], cnts


def adjacency(s_feats: torch.Tensor, sigma: float = 10.0) -> torch.Tensor:
    """Gaussian similarity graph over superpixel features with self-loops
    (gast/slic/superpixel.py:133-158 `get_A`)."""
    d2 = ((s_feats[:, None] - s_feats[None]) ** 2).sum(-1)
    a = torch.exp(-d2 / sigma ** 2)
    return a.fill_diagonal_(1.0)
