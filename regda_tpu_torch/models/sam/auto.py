"""The SAM bundle (counterpart of the head of regda_tpu/models/sam/auto.py):
`Sam` with `encode`, `decode_points`, `decode_points_fast` and `forward`, and
the point grid. The everything-mode generators that drive it are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from regda_tpu_torch.models.sam.decoder import MaskDecoder
from regda_tpu_torch.models.sam.prompt import PromptEncoder
from regda_tpu_torch.models.sam.vit import VIT_CONFIGS, ImageEncoderViT

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
