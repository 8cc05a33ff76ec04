"""SAM everything-mode (counterpart of regda_tpu/models/sam/auto.py): the `Sam`
bundle with `encode`, `decode_points`, `decode_points_fast` and `forward`, and
the two generators that drive it over a tile.

`SamAutomaticMaskGenerator.generate` keeps segment-anything's interface
(annotation dicts with full-resolution bool masks) and downloads every mask.
`SamRegionGenerator` keeps the masks on the device: boxes and areas are
computed there, the greedy NMS runs on the host on a few KB of scalars, and
the int32 region map is painted on the device and downloaded once.

Per crop: one encode of the crop resized to the model frame; the point grid
decoded in chunks of `points_per_batch` prompts through the fast decoder
(two-way and mask-head kernels); per chunk the predicted IoU and the
stability score of its 3 candidates a prompt, the stability by default exact
(counted on the logits resized to crop resolution, ops/kernels/stability.py)
or, with `stability_on_upscaled=False` or `REGDA_SAM_FAST_STABILITY=1`, on
the low-res logits; the first `mask_budget` candidates in point order that
pass both thresholds are kept; their masks are resized, thresholded, packed
and boxed (ops/kernels/mask_stats.py).

The functions are plain eager PyTorch. The composed resize matrices and the
point grids are cached per crop frame as device tensors. Which
implementation a kernel wrapper runs follows from the tensors' device.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from regda_tpu_torch.models.sam.decoder import MaskDecoder
from regda_tpu_torch.models.sam.prompt import PromptEncoder
from regda_tpu_torch.models.sam.vit import VIT_CONFIGS, ImageEncoderViT
from regda_tpu_torch.ops.kernels._band import ResizeFrame
from regda_tpu_torch.ops.kernels.mask_stats import mask_stats_fused, unpack_bits
from regda_tpu_torch.ops.kernels.stability import (stability_counts_blocked,
                                                   stability_counts_fused, unblock_masks)
from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel, resize_bilinear_half_pixel
from regda_tpu_torch.parallel.mesh import DataGroup, all_gather_objects, share

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_shape(h: int, w: int, long_side: int):
    """Longest-side resize target (upstream ResizeLongestSide rounding)."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


class Sam(nn.Module):
    """Image encoder, prompt encoder and mask decoder under segment-anything's
    state_dict names (`image_encoder.*`, `prompt_encoder.*`, `mask_decoder.*`,
    `pixel_mean`, `pixel_std`).

    `dtype` is the compute dtype of encoder and decoder; parameters stay
    float32. The default is bfloat16, as in the JAX package; pass
    torch.float32 to hold a float32 reference.
    """

    def __init__(self, vit_config: str = 'vit_b', img_size: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.img_size = img_size
        self.dtype = dtype
        self.image_encoder = ImageEncoderViT(img_size=img_size, dtype=dtype,
                                             **VIT_CONFIGS[vit_config])
        emb = img_size // 16
        self.prompt_encoder = PromptEncoder(image_embedding_size=(emb, emb),
                                            input_image_size=(img_size, img_size))
        self.mask_decoder = MaskDecoder(dtype=dtype)
        # an image is normalized with these before `encode` (0-255 units)
        self.register_buffer('pixel_mean', torch.from_numpy(SAM_PIXEL_MEAN).view(-1, 1, 1))
        self.register_buffer('pixel_std', torch.from_numpy(SAM_PIXEL_STD).view(-1, 1, 1))

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(B, img_size, img_size, 3) preprocessed -> (B, grid, grid, 256)."""
        return self.image_encoder(image)

    def decode_points(self, image_embedding, points, labels):
        """image_embedding (1, grid, grid, 256); points (P, 1, 2) input-res
        xy; labels (P, 1). Returns (low-res mask logits (P, 3, 4 * grid,
        4 * grid), iou (P, 3))."""
        sparse, dense = self.prompt_encoder(points, labels)
        image_pe = self.prompt_encoder.get_dense_pe()
        # point prompts share the no-mask dense embedding: with a batch-1
        # dense the decoder shares layer 0's key projections across prompts
        return self.mask_decoder(image_embedding, image_pe, sparse, dense[:1],
                                 multimask_output=True)

    def decode_points_fast(self, image_embedding, points, labels,
                           fused_upscale: bool = True, mask_dtype=None,
                           iou_gate_thresh=None, blocked_masks: bool = False):
        """`decode_points` through the fast decoder (same parameters, same
        math; see fast_decoder.py): the prompt-resident two-way kernel and
        the fused upscale + hypernetwork mask head. iou_gate_thresh is the
        everything-mode IoU gate (failing prompts skip the mask head and
        return zero masks); blocked_masks returns (P, 48, grid * grid)
        candidate-major masks instead of (P, 3, 4 * grid, 4 * grid)."""
        from regda_tpu_torch.models.sam.fast_decoder import mask_decoder_fast
        sparse, dense = self.prompt_encoder(points, labels)
        image_pe = self.prompt_encoder.get_dense_pe()
        return mask_decoder_fast(self.mask_decoder, image_embedding, image_pe,
                                 sparse, dense[:1], multimask_output=True,
                                 fused_upscale=fused_upscale, mask_dtype=mask_dtype,
                                 iou_gate_thresh=iou_gate_thresh,
                                 blocked_masks=blocked_masks)

    def forward(self, image, points, labels):
        return self.decode_points(self.encode(image), points, labels)


def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    xs, ys = np.meshgrid(pts, pts)
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)   # (n^2, 2) in [0, 1]


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float):
    """Crop pyramid (x0, y0, x1, y1) boxes + layer indices."""
    crop_boxes = [[0, 0, im_size[1], im_size[0]]]
    layer_idxs = [0]
    short_side = min(im_size)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_size[1], n_crops_per_side, overlap)
        crop_h = crop_len(im_size[0], n_crops_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_size[1]),
                                   min(y0 + crop_h, im_size[0])])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def _box_iou(box, boxes):
    x0 = np.maximum(box[0], boxes[:, 0])
    y0 = np.maximum(box[1], boxes[:, 1])
    x1 = np.minimum(box[2], boxes[:, 2])
    y1 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-7)


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float):
    """Greedy box NMS, torchvision semantics (suppress iou > thresh, areas
    (x1 - x0) * (y1 - y0)) with a STABLE descending score sort: the cross-crop
    pass scores by 1 / crop area, so whole crops tie and the tie-break must be
    data order (ascending index)."""
    order = np.argsort(-scores, kind='stable')
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _box_iou(boxes[i], boxes[order[1:]])
        order = order[1:][ious <= iou_thresh]
    return np.asarray(keep, np.int64)


def is_box_near_crop_edge(boxes, crop_box, orig_hw, atol: float = 20.0):
    """Upstream amg.is_box_near_crop_edge: True for boxes (image coords, XYXY)
    within atol of the crop boundary but NOT within atol of the image
    boundary. Everything-mode drops these before per-crop NMS (an enclosing
    crop is expected to find them whole)."""
    boxes = np.asarray(boxes, np.float32)
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray([0, 0, orig_hw[1], orig_hw[0]], np.float32)
    near_crop = np.abs(boxes - crop[None]) <= atol
    near_image = np.abs(boxes - orig[None]) <= atol
    return np.any(near_crop & ~near_image, axis=1)


def _crop_nms_scores(crop_box) -> float:
    """Upstream cross-crop NMS score: 1 / area(source crop box). Masks from
    smaller crops win; predicted IoU plays no role in the cross-crop pass."""
    x0, y0, x1, y1 = crop_box
    return 1.0 / float((x1 - x0) * (y1 - y0))


def _lrh_max_regions() -> int:
    from regda_tpu_torch.ops.lrh import MAX_REGIONS
    return MAX_REGIONS


def regions_from_anns(anns: list[dict], size, area_threshold: int = 1024) -> np.ndarray:
    """Pack annotations into an int32 region map (id = index + 1, 0 =
    unassigned), painting only masks with area >= threshold."""
    mask = np.zeros(size, np.int32)
    max_id = 0
    for i, ann in enumerate(anns):
        if ann['area'] >= area_threshold:
            mask[ann['segmentation']] = i + 1
            max_id = i + 1
    if max_id >= _lrh_max_regions():
        warnings.warn(
            f'region map contains id {max_id} >= LRH MAX_REGIONS ({_lrh_max_regions()}); '
            'LRH will treat over-budget regions as unassigned (pixels keep their '
            'original pseudo-label)')
    return mask


def composed_resize_matrices(img_size: int, key_hw, low: int):
    """Compose upstream postprocess_masks' resize chain (low-res -> img_size
    bilinear, unpad to (nh, nw), -> (ch, cw) bilinear, all half-pixel) into ONE
    float32 matrix per axis: (m_h (ch, low), m_w (cw, low)) for the crop frame
    key_hw = (nh, nw, ch, cw). A row has at most four non-zeros, all adjacent."""
    nh, nw, ch, cw = key_hw
    u_h = _interp_matrix_half_pixel(low, img_size)[:nh]
    u_w = _interp_matrix_half_pixel(low, img_size)[:nw]
    m_h = _interp_matrix_half_pixel(nh, ch) @ u_h        # (ch, low)
    m_w = _interp_matrix_half_pixel(nw, cw) @ u_w        # (cw, low)
    return m_h.astype(np.float32), m_w.astype(np.float32)


def _to_host_async(t: torch.Tensor):
    """-> (host tensor, event or None): a non-blocking copy into pinned memory
    and the event that marks its arrival; a CPU tensor is returned as it is."""
    if t.device.type != 'cuda':
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


class _StageClock:
    """Milliseconds per named stage. On the card a stage is timed by a pair of
    CUDA events on the current stream, so its time is the stretch of the
    device's timeline between them, idle gaps included; host stages and the
    CPU device use the host clock. Off (`enabled=False`) it does nothing."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == 'cuda'
        self.ms: dict[str, float] = {}
        self._pairs: list = []

    @contextlib.contextmanager
    def span(self, name: str, host: bool = False):
        if not self.enabled:
            yield
        elif host or not self.cuda:
            t0 = time.perf_counter()
            yield
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._pairs.append((name, start, end))

    def collect(self) -> dict[str, float]:
        """Wait for the open event pairs and return the sums so far."""
        for name, start, end in self._pairs:
            end.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        self._pairs.clear()
        return dict(self.ms)


class SamAutomaticMaskGenerator:
    """segment-anything's `SamAutomaticMaskGenerator` over the port's `Sam`:
    `generate(image)` returns annotation dicts in upstream order.

    The model carries its weights and its device; `compute_dtype` (default: the
    model's) is the dtype of the encoder's input and of the mask logits. The
    reference's environment switches are arguments here: `blocked_masks`
    (masks stay in the mask head's candidate-major blocked layout through
    stability and selection; only the selected ones are interleaved),
    `budget_skip` (see `_decode_all`), `iou_gate` (prompts that fail
    `pred_iou_thresh` skip the mask head and the stability resize) and
    `timing`. There is no switch that turns a kernel off. `group` (a
    parallel.DataGroup) makes `SamRegionGenerator.generate_regions_batch`
    split a batch of tiles over the ranks.
    """

    def __init__(self, model: Sam, points_per_side: int = 32,
                 points_per_batch: int = 256, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 mask_budget: int = 256, compute_dtype: Optional[torch.dtype] = None,
                 stability_on_upscaled: Optional[bool] = None,
                 blocked_masks: bool = True, budget_skip: bool = True,
                 iou_gate: bool = True, timing: bool = False,
                 group: Optional[DataGroup] = None):
        self.model = model.eval()
        self.group = group
        self.device = next(model.parameters()).device
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.mask_budget = mask_budget
        self.compute_dtype = compute_dtype or model.dtype
        self.img_size = model.img_size
        if stability_on_upscaled is None:
            # exact by default: REGDA_SAM_FAST_STABILITY=1 opts into scoring
            # the low-res logits
            stability_on_upscaled = not os.environ.get('REGDA_SAM_FAST_STABILITY')
        # exact: upstream scores stability on the logits postprocessed to crop
        # resolution (low-res -> model frame -> unpad -> crop size, bilinear);
        # the chain is composed into one matrix per axis and the counts are
        # taken at crop resolution. Fast: the low-res logits are scored
        # directly, scale-invariant to first order, a deviation from upstream.
        self.stability_on_upscaled = stability_on_upscaled
        self.blocked_masks = blocked_masks
        self.budget_skip = budget_skip
        self.iou_gate = iou_gate
        self.timing = timing
        self.clock = _StageClock(timing, self.device)
        # decode chunks run and skipped, and (with `timing`) what passed each filter
        self.counts = {'chunks_live': 0, 'chunks_skipped': 0}
        self._dev_counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        self._frames: dict = {}
        self._grids: dict = {}

    # ------------------------------------------------------------ cached pieces
    def _exact_stability_matrices(self, key_hw, low: int):
        return composed_resize_matrices(self.img_size, key_hw, low)

    def _frame(self, key_hw) -> ResizeFrame:
        """The composed matrices of one crop frame on the device, dense and in
        the kernels' band form."""
        if key_hw not in self._frames:
            self._frames[key_hw] = ResizeFrame(
                *self._exact_stability_matrices(key_hw, self.img_size // 4), self.device)
        return self._frames[key_hw]

    def _points(self, layer_idx: int, nh: int, nw: int):
        """The layer's point grid in the resized crop's pixels, padded to whole
        chunks: (points (n, 2) float32, valid (n,) bool) on the device."""
        key = (layer_idx, nh, nw)
        if key not in self._grids:
            n_side = self.points_per_side // (
                self.crop_n_points_downscale_factor ** layer_idx)
            pts = build_point_grid(n_side) * np.array([nw, nh], np.float32)
            pad = (-len(pts)) % self.points_per_batch
            padded = np.concatenate([pts, np.zeros((pad, 2), np.float32)]).astype(np.float32)
            valid = np.arange(len(padded)) < len(pts)
            self._grids[key] = (torch.from_numpy(padded).to(self.device),
                                torch.from_numpy(valid).to(self.device))
        return self._grids[key]

    # --------------------------------------------------------------- the model
    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        """(B, img_size, img_size, 3) preprocessed -> float32 embeddings."""
        with self.clock.span('encode'):
            return self.model.encode(image.to(self.compute_dtype)).float()

    def _decode_chunk(self, embedding, points, key_hw=None):
        """One chunk of prompts against one embedding (1, g, g, 256): points
        (P, 2) input-res xy -> (masks, iou (P, 3), stability (P, 3)). The masks
        come back in the compute dtype, interleaved (P, 3, S, S) or, blocked,
        candidate-major (P, 48, (S // 4)^2)."""
        exact = self.stability_on_upscaled and key_hw is not None
        gate = float(self.pred_iou_thresh) if self.iou_gate else None
        off = self.stability_score_offset
        labels = torch.ones(points.shape[:1] + (1,), dtype=torch.float32, device=points.device)
        with self.clock.span('decode'):
            masks, iou = self.model.decode_points_fast(
                embedding, points[:, None, :], labels, True, self.compute_dtype,
                iou_gate_thresh=gate, blocked_masks=self.blocked_masks)
        p, m3 = iou.shape
        s = self.img_size // 4
        with self.clock.span('stability'):
            if exact:
                frame = self._frame(key_hw)
                # gated candidates skip their resize; the filter drops them
                # by the same IoU array
                act = (iou > gate).reshape(-1) if gate is not None else None
                if self.blocked_masks:
                    h = s // 4
                    inter, union = stability_counts_blocked(
                        masks.reshape(p * m3, 16 * h, h), frame, h, h, off, act)
                else:
                    inter, union = stability_counts_fused(
                        masks.reshape(p * m3, s, s), frame, off, act)
                inter, union = inter.reshape(p, m3), union.reshape(p, m3)
            else:
                # the offsets (+-1.0) are exact in bfloat16 and the counts are
                # order-free, so the blocked layout needs no conversion
                cand = masks.reshape(p, m3, -1)
                inter = (cand > off).sum(dim=-1).float()
                union = (cand > -off).sum(dim=-1).float()
            stability = inter / union.clamp(min=1.0)
        return masks, iou, stability

    def _decode_all(self, embedding, layer_idx: int, key_hw, skip: bool = False):
        """The whole point grid against one embedding, chunk by chunk, keeping
        the FIRST `mask_budget` candidates in point order that pass the IoU
        and stability thresholds: -> (logits (budget, S, S), iou (budget,), ok
        (budget,)); slots past the number of passing candidates hold zeros
        and ok = False, and every consumer ANDs with ok.

        Each chunk's passing candidates are copied to their slots (running
        ordinal + `index_copy_`; what does not land goes to a spare row), so
        the selected logits are the decoder's own bits and the candidate
        stream is never stacked.

        skip: the budget skip. Once the budget is full, later chunks cannot
        contribute and are not decoded. The count of passing candidates
        lives on the device; it is read one chunk late, through a
        non-blocking copy made after chunk k - 2 and waited for when chunk
        k - 1 is already queued, so the device never waits for the host. A
        chunk decoded in vain changes nothing: ordinals at or past the
        budget never land."""
        nh, nw = key_hw[:2]
        pts, valid = self._points(layer_idx, nh, nw)
        pb = self.points_per_batch
        d = pb * 3
        n_chunks = pts.shape[0] // pb
        bud = min(self.mask_budget, pts.shape[0] * 3)
        low = self.img_size // 4
        dev = embedding.device
        t_iou, t_st = self.pred_iou_thresh, self.stability_score_thresh
        sel_m = torch.zeros((bud + 1, low * low), dtype=self.compute_dtype, device=dev)
        sel_iou = torch.zeros((bud + 1,), dtype=torch.float32, device=dev)
        sel_ok = torch.zeros((bud + 1,), dtype=torch.bool, device=dev)
        n_ok = torch.zeros((), dtype=torch.int64, device=dev)
        reads = []                    # (host copy of n_ok, event) after each chunk
        for k in range(n_chunks):
            if skip and k >= 2:
                host, event = reads[k - 2]
                if event is not None:
                    event.synchronize()
                if int(host) >= bud:
                    self.counts['chunks_skipped'] += n_chunks - k
                    break
            masks, iou, stab = self._decode_chunk(embedding, pts[k * pb:(k + 1) * pb], key_hw)
            self.counts['chunks_live'] += 1
            with self.clock.span('select'):
                v = valid[k * pb:(k + 1) * pb, None]
                okf = (v & (iou > t_iou) & (stab >= t_st)).reshape(d)
                ordn = n_ok + torch.cumsum(okf, dim=0) - 1
                dst = torch.where(okf & (ordn < bud), ordn, bud)
                sel_m.index_copy_(0, dst, masks.reshape(d, low * low))
                sel_iou.index_copy_(0, dst, iou.reshape(d).float())
                sel_ok.index_copy_(0, dst, okf)
                n_ok = n_ok + okf.sum()
                if self.timing:
                    self._dev_counts += torch.stack(
                        [v.sum() * 3, (v & (iou > t_iou)).sum(), okf.sum()])
                if skip:
                    reads.append(_to_host_async(n_ok))
        with self.clock.span('select'):
            if self.blocked_masks:
                h = low // 4
                logits = unblock_masks(sel_m[:bud].reshape(bud, 16 * h, h), h, h)
            else:
                logits = sel_m[:bud].reshape(bud, low, low)
        return logits, sel_iou[:bud], sel_ok[:bud]

    def _mask_stats(self, logits, ok, key_hw):
        """(M, S, S) selected logits -> (bits (M, ch, ceil(cw / 8)) uint8 masks
        at CROP resolution through the composed resize chain, upstream's
        postprocess_masks then binarize; boxes (M, 4) inclusive; areas (M,)).
        Slots whose `ok` is False cost nothing and come back as zeros."""
        with self.clock.span('mask_stats'):
            return mask_stats_fused(logits, self._frame(key_hw), active=ok)

    def _crop_bits(self, logits, ok, key_hw):
        """Bit-packed crop-resolution masks of the selected logits; unpack
        with np.unpackbits(...)[:, :, :cw]."""
        return self._mask_stats(logits, ok, key_hw)[0]

    def report(self) -> dict:
        """Counts and (with `timing`) stage milliseconds since construction or
        the last `reset_report()`; waits for the stages' events."""
        out = dict(self.counts)
        if self.timing:
            valid, iou_pass, both = (int(v) for v in self._dev_counts.cpu())
            out.update(candidates=valid, pass_iou=iou_pass, pass_iou_and_stability=both,
                       stage_ms=self.clock.collect())
        return out

    def reset_report(self) -> None:
        self.clock.collect()
        self.clock.ms.clear()
        self.counts = {'chunks_live': 0, 'chunks_skipped': 0}
        self._dev_counts.zero_()

    # ---------------------------------------------------------------- pipeline
    def _preprocess(self, image_np: np.ndarray):
        """uint8 HWC crop -> ((1, img_size, img_size, 3) normalized float32,
        (nh, nw)). The resize is exact float half-pixel bilinear, the same
        math as the device preprocess and F.interpolate(align_corners=False).
        Upstream resizes through PIL (fixed-point coefficients, uint8
        rounding); the deviation is bounded by the uint8 quantum."""
        h, w = image_np.shape[:2]
        nh, nw = preprocess_shape(h, w, self.img_size)
        x = image_np.astype(np.float32)
        if (nh, nw) != (h, w):
            r_h = _interp_matrix_half_pixel(h, nh).astype(np.float32)
            r_w = _interp_matrix_half_pixel(w, nw).astype(np.float32)
            x = np.einsum('Hh,hwc->Hwc', r_h, x)
            x = np.einsum('Ww,Hwc->HWc', r_w, x)
        img = (x - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
        out = np.zeros((self.img_size, self.img_size, 3), np.float32)
        out[:nh, :nw] = img
        return out[None], (nh, nw)

    def _process_crop(self, image_np: np.ndarray, crop_box, layer_idx: int):
        x0, y0, x1, y1 = crop_box
        crop = image_np[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        batchable, (nh, nw) = self._preprocess(crop)
        embedding = self._encode(torch.from_numpy(batchable).to(self.device))
        key_hw = (nh, nw, ch, cw)
        sel_logits, sel_iou, sel_ok = self._decode_all(embedding, layer_idx, key_hw)
        ok = sel_ok.cpu().numpy()
        if not ok.any():
            return []
        ious = sel_iou.cpu().numpy()[ok]
        packed = self._crop_bits(sel_logits, sel_ok, key_hw).cpu().numpy()
        masks_crop = np.unpackbits(packed, axis=-1)[:, :, :cw].astype(bool)[ok]

        # boxes in upstream's INCLUSIVE max-index convention (empty masks ->
        # [0, 0, 0, 0], kept: amg.batched_mask_to_box)
        boxes = np.zeros((len(masks_crop), 4), np.float32)
        areas = np.zeros((len(masks_crop),), np.int64)
        for i, m in enumerate(masks_crop):
            ys, xs = np.nonzero(m)
            if ys.size:
                boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
                areas[i] = ys.size

        # drop masks whose box is near the crop edge but not the image edge
        # (upstream _process_batch, BEFORE per-crop NMS)
        keep = ~is_box_near_crop_edge(boxes + np.array([x0, y0, x0, y0], np.float32),
                                      crop_box, image_np.shape[:2])
        masks_crop, ious = masks_crop[keep], ious[keep]
        boxes, areas = boxes[keep], areas[keep]
        if not len(masks_crop):
            return []

        # per-crop NMS scored by predicted IoU (crop-frame boxes; NMS is
        # translation-invariant, so uncropping afterwards matches upstream)
        anns = []
        for i in nms_boxes(boxes, ious, self.box_nms_thresh):
            full = np.zeros(image_np.shape[:2], bool)
            full[y0:y1, x0:x1] = masks_crop[i]
            anns.append({'segmentation': full,
                         'area': int(areas[i]),
                         'bbox': (boxes[i] + [x0, y0, x0, y0]).tolist(),
                         'predicted_iou': float(ious[i]),
                         'crop_box': list(crop_box)})
        return anns

    @torch.inference_mode()
    def generate(self, image_np: np.ndarray) -> list[dict]:
        """image_np: uint8 (H, W, 3). Returns annotation dicts in upstream
        order (cross-crop NMS keep order, the order that region-id packing
        consumes)."""
        crop_boxes, layer_idxs = generate_crop_boxes(
            image_np.shape[:2], self.crop_n_layers, self.crop_overlap_ratio)
        all_anns = []
        for box, layer in zip(crop_boxes, layer_idxs):
            anns = self._process_crop(image_np, box, layer)
            for a in anns:
                a['crop_layer'] = layer
            all_anns += anns
        if not all_anns:
            return []
        if len(crop_boxes) > 1:
            # upstream cross-crop NMS: scores are 1 / area(source crop box)
            boxes = np.asarray([a['bbox'] for a in all_anns], np.float32)
            scores = np.asarray([_crop_nms_scores(a['crop_box']) for a in all_anns],
                                np.float32)
            keep = nms_boxes(boxes, scores, self.crop_nms_thresh)
            all_anns = [all_anns[i] for i in keep]
        return all_anns


class SamRegionGenerator(SamAutomaticMaskGenerator):
    """Device-resident everything-mode for region-map production.

    `generate()` keeps segment-anything's interface but must download every
    mask. This subclass computes boxes and areas on the device, runs the
    (tiny) greedy NMS on host scalars, paints the int32 region map ON THE
    DEVICE and downloads only the final (H, W) map. Region contents match
    `generate()` + `regions_from_anns`; ids come out in NMS keep order.

    `generate_regions(image)` works crop by crop; `generate_regions_batch
    (tiles)` queues all device work of a batch of same-sized tiles before its
    first host read (phase 1: per tile one upload, one preprocess of the whole
    crop pyramid, ONE encode over all crop positions, then decode and mask
    statistics per position), runs NMS per tile on the downloaded scalars
    (phase 2) and paints per crop position (phase 3);
    `generate_regions_stream(batches)` keeps several batches in flight.
    """

    # ------------------------------------------------------------ device pieces
    def _preprocess_device(self, crop_u8: torch.Tensor) -> torch.Tensor:
        """uint8 crop (ch, cw, 3) on the device -> (1, img_size, img_size, 3)
        resized (half-pixel bilinear), normalized, zero-padded, in the compute
        dtype. Uploading the uint8 crop moves 16x fewer bytes than the
        resized float32 square."""
        size = self.img_size
        ch, cw = crop_u8.shape[-3:-1]
        nh, nw = preprocess_shape(ch, cw, size)
        x = crop_u8.float()
        x = x[None] if x.ndim == 3 else x
        x = resize_bilinear_half_pixel(x, (nh, nw))
        x = (x - self.model.pixel_mean.view(3)) / self.model.pixel_std.view(3)
        return torch.nn.functional.pad(x, (0, 0, 0, size - nw, 0, size - nh)).to(
            self.compute_dtype)

    def _pyramid_pre(self, tile_u8: torch.Tensor, boxes) -> torch.Tensor:
        """uint8 TILE on the device -> (len(boxes), img_size, img_size, 3)
        preprocessed crop pyramid: one tile upload serves every crop."""
        with self.clock.span('preprocess'):
            return torch.cat([self._preprocess_device(tile_u8[by0:by1, bx0:bx1])
                              for (bx0, by0, bx1, by1) in boxes])

    def _paint(self, canvases, packed, ids, paint_key):
        """Max-paint ids into the canvas region covered by one crop position,
        in place: canvases (N, H, W) int32, packed (N, K, ch, ceil(cw / 8))
        bit-packed crop-resolution masks, ids (N, K) region ids below
        LRH's MAX_REGIONS (0 paints nothing)."""
        x0, y0, ch, cw = paint_key
        bits = unpack_bits(packed, cw).to(torch.int16)                # (N, K, ch, cw)
        contrib = (bits * ids[:, :, None, None].to(torch.int16)).amax(dim=1)
        region = canvases[:, y0:y0 + ch, x0:x0 + cw]
        region.copy_(torch.maximum(region, contrib.to(torch.int32)))

    # ----------------------------------------------------------------- phase 1
    def _position_record(self, parts, ch: int, cw: int):
        """Stack one crop position's per-tile results and start the host copy
        of its scalars: parts = [(packed, boxes, areas, iou, ok)] per tile."""
        packed, boxes, areas, iou, ok = (torch.stack(f) for f in zip(*parts))
        scalars = torch.cat([boxes, areas[..., None], iou[..., None],
                             ok[..., None].float()], dim=-1)          # (N, M, 7)
        host, event = _to_host_async(scalars)
        return dict(packed=packed, scalars=host, event=event, ch=ch, cw=cw)

    def _crop_device(self, image_np, crop_box, layer_idx):
        """Everything-mode for one crop of one image; masks stay on the device."""
        x0, y0, x1, y1 = crop_box
        crop = torch.from_numpy(np.ascontiguousarray(image_np[y0:y1, x0:x1])).to(self.device)
        ch, cw = crop.shape[:2]
        nh, nw = preprocess_shape(ch, cw, self.img_size)
        with self.clock.span('preprocess'):
            batchable = self._preprocess_device(crop)
        embedding = self._encode(batchable)
        key_hw = (nh, nw, ch, cw)
        logits, iou, ok = self._decode_all(embedding, layer_idx, key_hw)
        packed, boxes, areas = self._mask_stats(logits, ok, key_hw)
        return self._position_record([(packed, boxes, areas, iou, ok)], ch, cw)

    def _phase1_pyramid(self, tiles, crop_boxes, layer_idxs):
        """Phase 1 with the CROP PYRAMID batched per tile: all crop positions
        of a tile are preprocessed to the common model frame and encoded in ONE
        batched ViT pass, then decoded position by position. Positions that
        share a crop size and layer share their composed matrices and point
        grid, and their mask statistics are one kernel call. No host read
        apart from the budget skip's late count."""
        groups: dict = {}
        for ci, (box, layer) in enumerate(zip(crop_boxes, layer_idxs)):
            x0, y0, x1, y1 = box
            groups.setdefault((y1 - y0, x1 - x0, layer), []).append(ci)
        order = [ci for cis in groups.values() for ci in cis]
        boxes_order = [crop_boxes[ci] for ci in order]

        results = {ci: [] for ci in range(len(crop_boxes))}
        for t in tiles:
            tile = torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
            embs = self._encode(self._pyramid_pre(tile, boxes_order))
            off = 0
            for (ch, cw, layer), cis in groups.items():
                nh, nw = preprocess_shape(ch, cw, self.img_size)
                key_hw = (nh, nw, ch, cw)
                # the embedding keeps its leading 1 for decode_points_fast
                sel = [self._decode_all(embs[off + k:off + k + 1], layer, key_hw,
                                        skip=self.budget_skip) for k in range(len(cis))]
                logits, iou, ok = (torch.cat(f) for f in zip(*sel))
                packed, boxes, areas = self._mask_stats(logits, ok, key_hw)
                bud = sel[0][1].shape[0]
                for k, ci in enumerate(cis):
                    s = slice(k * bud, (k + 1) * bud)
                    results[ci].append((packed[s], boxes[s], areas[s], iou[s], ok[s]))
                off += len(cis)

        per_pos = []
        for ci, box in enumerate(crop_boxes):
            per_pos.append(self._position_record(results[ci], box[3] - box[1],
                                                 box[2] - box[0]))
        return per_pos

    @torch.inference_mode()
    def _submit_batch(self, tiles, area_threshold):
        """Queue ALL of one batch's device work (phase 1) and start the host
        copies of the scalars that NMS will need; the state tuple feeds
        `_phases23` (now or later)."""
        self._t_gen_start = time.perf_counter()
        h, w = tiles[0].shape[:2]
        if any(t.shape[:2] != (h, w) for t in tiles):
            raise ValueError("the tiles of a batch must share one size")
        crop_boxes, layer_idxs = generate_crop_boxes(
            (h, w), self.crop_n_layers, self.crop_overlap_ratio)
        per_pos = self._phase1_pyramid(tiles, crop_boxes, layer_idxs)
        return len(tiles), per_pos, crop_boxes, h, w, area_threshold

    # ------------------------------------------------------------ phases 2 and 3
    def _tile_ids(self, pos_np, ti: int, crop_boxes, h: int, w: int, area_threshold):
        """Phase 2 for one tile, on host scalars: per crop position the region
        id of each budget slot (0 = not painted)."""
        cand = []   # (ci, mask_idx, box_img, area, crop_score)
        stats = self.counts
        for ci, (p, box) in enumerate(zip(pos_np, crop_boxes)):
            b_all = p['boxes'][ti] + np.array([box[0], box[1], box[0], box[1]], np.float32)
            # upstream candidate set: iou/stability survivors minus boxes near
            # the crop edge (not the image edge); the LRH area threshold gates
            # PAINTING only: small anns keep their id slots and take part in NMS
            valid = p['ok'][ti] & ~is_box_near_crop_edge(b_all, box, (h, w))
            idxs = np.nonzero(valid)[0]
            if self.timing:
                stats['selected'] = stats.get('selected', 0) + int(p['ok'][ti].sum())
                stats['off_crop_edge'] = stats.get('off_crop_edge', 0) + len(idxs)
            if not len(idxs):
                continue
            keep = nms_boxes(b_all[idxs], p['iou'][ti][idxs], self.box_nms_thresh)
            for k in keep:
                cand.append((ci, int(idxs[k]), b_all[idxs[k]],
                             float(p['areas'][ti][idxs[k]]), _crop_nms_scores(box)))
        ids = [np.zeros(p['ok'].shape[1], np.int32) for p in pos_np]
        if not cand:
            return ids
        boxes = np.stack([c[2] for c in cand])
        scores = np.array([c[4] for c in cand])
        # cross-crop NMS scored by 1 / crop area (upstream); single crop: data
        # order IS the per-crop keep order
        order = (nms_boxes(boxes, scores, self.crop_nms_thresh)
                 if len(crop_boxes) > 1 else np.arange(len(cand)))
        if len(order) >= _lrh_max_regions():
            warnings.warn(
                f'{len(order)} regions survive NMS, >= LRH MAX_REGIONS '
                f'({_lrh_max_regions()}); keeping the first {_lrh_max_regions() - 1} '
                'so ids stay within the LRH budget')
            order = order[:_lrh_max_regions() - 1]
        # global ids in keep order (max-paint: the higher id wins, as the
        # reference paint loop's sequential overwrite); anns below the area
        # threshold consume an id but are never painted
        painted = 0
        for gid, oi in enumerate(order):
            ci, mi, _, area, _ = cand[oi]
            if area >= area_threshold:
                ids[ci][mi] = gid + 1
                painted += 1
        if self.timing:
            for key, val in (('per_crop_nms', len(cand)), ('cross_crop_nms', len(order)),
                             ('painted', painted)):
                stats[key] = stats.get(key, 0) + val
        return ids

    @torch.inference_mode()
    def _phases23(self, n_tiles, per_pos, crop_boxes, h, w, area_threshold):
        t0 = time.perf_counter()
        # phase 2: per-tile NMS on the scalars, once their copy has arrived
        pos_np = []
        for p in per_pos:
            if p['event'] is not None:
                p['event'].synchronize()
            s = p['scalars'].numpy()
            pos_np.append(dict(boxes=s[..., :4], areas=s[..., 4], iou=s[..., 5],
                               ok=s[..., 6] > 0))
        t1 = time.perf_counter()
        with self.clock.span('nms', host=True):
            all_ids = [self._tile_ids(pos_np, ti, crop_boxes, h, w, area_threshold)
                       for ti in range(n_tiles)]
        t2 = time.perf_counter()
        # phase 3: paint per crop position, one canvas download. NMS already
        # happened on the host, so only the budget slots that got a region id
        # in SOME tile are gathered into the paint
        canvases = torch.zeros((n_tiles, h, w), dtype=torch.int32, device=self.device)
        max_id = 0
        with self.clock.span('paint'):
            for ci, (p, box) in enumerate(zip(per_pos, crop_boxes)):
                ids_ci = np.stack([all_ids[ti][ci] for ti in range(n_tiles)])
                used = np.nonzero(ids_ci.any(axis=0))[0]
                if not len(used):
                    continue
                max_id = max(max_id, int(ids_ci.max()))
                self._paint(canvases,
                            p['packed'][:, torch.from_numpy(used).to(self.device)],
                            torch.from_numpy(ids_ci[:, used]).to(self.device),
                            (box[0], box[1], p['ch'], p['cw']))
        # ids are assigned on the HOST, so the range of the canvas is known
        # before the download: an all-empty batch skips it (the canvas is the
        # zeros it was made as), and uint8 ships whenever every id fits
        if max_id == 0:
            out = np.zeros((n_tiles, h, w), np.int32)
        else:
            with self.clock.span('download'):
                host, event = _to_host_async(
                    canvases.to(torch.uint8 if max_id <= 255 else torch.int16))
            if event is not None:
                event.synchronize()
            out = host.numpy().astype(np.int32)
        if self.timing:
            t3 = time.perf_counter()
            disp = t0 - getattr(self, '_t_gen_start', t0)
            print(f'[sam-timing] n={n_tiles} dispatch={disp:.3f}s '
                  f'drain+scalars={t1 - t0:.3f}s nms={t2 - t1:.3f}s '
                  f'paint+dl={t3 - t2:.3f}s', flush=True)
        return [out[i] for i in range(n_tiles)]

    # ---------------------------------------------------------------- the API
    @torch.inference_mode()
    def generate_regions(self, image_np: np.ndarray, area_threshold: int = 1024) -> np.ndarray:
        """uint8 (H, W, 3) -> int32 (H, W) region map (0 = unassigned), crop by
        crop (one encode per crop, no budget skip)."""
        self._t_gen_start = time.perf_counter()
        h, w = image_np.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            (h, w), self.crop_n_layers, self.crop_overlap_ratio)
        per_pos = [self._crop_device(image_np, box, layer)
                   for box, layer in zip(crop_boxes, layer_idxs)]
        return self._phases23(1, per_pos, crop_boxes, h, w, area_threshold)[0]

    def generate_regions_batch(self, tiles: 'list[np.ndarray]',
                               area_threshold: int = 1024) -> 'list[np.ndarray]':
        """Region maps of a batch of same-sized tiles: ALL device work of
        every tile is queued before the first scalars are read, then NMS runs
        per tile on the host and the paints are queued back to back.

        With `group`, each rank makes the maps of its share of the tiles
        (`parallel.share`; the counterpart of the JAX generator's `_phase1_sharded`:
        every device encodes and decodes its own tiles) and the maps are
        gathered, so that every rank returns all of them in order. A tile's
        map does not depend on the other tiles of its batch (phase 1 runs
        tile by tile), so the maps equal the one-process ones."""
        if self.group is None:
            return self._phases23(*self._submit_batch(tiles, area_threshold))
        own = tiles[share(self.group, len(tiles))]
        maps = self._phases23(*self._submit_batch(own, area_threshold)) if own else []
        return [m for part in all_gather_objects(maps, self.group) for m in part]

    def generate_regions_stream(self, batches, area_threshold: int = 1024, depth: int = 3):
        """Pipelined region generation over an iterable of tile batches: up to
        `depth` batches have their phase 1 queued BEFORE the oldest one's host
        tail (scalar download, NMS, paint, canvas download) runs, so the
        device works on the next batch meanwhile. Yields one list of region
        maps per input batch, in order, each identical to
        `generate_regions_batch`'s; depth changes scheduling only. With a
        group, each batch is split over the ranks (`generate_regions_batch`),
        one batch at a time."""
        if self.group is not None:
            for tiles in batches:
                yield self.generate_regions_batch(tiles, area_threshold)
            return
        q = deque()
        for tiles in batches:
            q.append(self._submit_batch(tiles, area_threshold))
            if len(q) > max(depth, 1):
                yield self._phases23(*q.popleft())
        while q:
            yield self._phases23(*q.popleft())
