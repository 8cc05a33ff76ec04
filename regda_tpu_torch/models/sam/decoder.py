"""SAM mask decoder (counterpart of regda_tpu/models/sam/decoder.py): the
two-way transformer and the hypernetwork mask heads, all stock PyTorch. One
call decodes a batch of point prompts against a single image embedding.

This is the stock twin. Everything-mode takes `fast_decoder.py` instead
(`Sam.decode_points_fast`): the same parameters and the same math through the
fused two-way and mask-head kernels; this module is what that path is held
against.

Parameter names are segment-anything's. Maps are NHWC. `dtype` is the
compute dtype of the `Linear`s and the two transposed convs; LayerNorms, the
softmax and the IoU head compute in float32, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from regda_tpu_torch.models.sam.vit import LayerNorm2d, Linear, MLPBlock


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in float32 whatever the input's dtype (eps 1e-5)."""

    def forward(self, x):
        return super().forward(x.float())


class AttentionDS(nn.Module):
    """Multi-head attention with optional internal downsampling; the softmax
    is taken in float32 whatever the compute dtype."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 downsample_rate: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        dim = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dim, dim, dtype=dtype)
        self.k_proj = Linear(embed_dim, dim, dtype=dtype)
        self.v_proj = Linear(embed_dim, dim, dtype=dtype)
        self.out_proj = Linear(dim, embed_dim, dtype=dtype)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        qh, kh, vh = (self._split(self.q_proj(q)), self._split(self.k_proj(k)),
                      self._split(self.v_proj(v)))
        attn = (qh @ kh.transpose(-1, -2)) / (qh.shape[-1] ** 0.5)
        attn = torch.softmax(attn.float(), dim=-1)
        out = attn.to(vh.dtype) @ vh
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = AttentionDS(embed_dim, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(embed_dim)
        self.cross_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2, dtype=dtype)
        self.norm2 = LayerNorm(embed_dim)
        self.mlp = MLPBlock(embed_dim, mlp_dim, dtype, act=F.relu)
        self.norm3 = LayerNorm(embed_dim)
        self.norm4 = LayerNorm(embed_dim)
        self.cross_attn_image_to_token = AttentionDS(embed_dim, num_heads, 2, dtype=dtype)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries)

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        return queries, self.norm4(keys)


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(depth)])
        self.final_attn_token_to_image = AttentionDS(embed_dim, num_heads, 2, dtype=dtype)
        self.norm_final_attn = LayerNorm(embed_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding, image_pe: (B or 1, H, W, C); point_embedding
        (P, N, C). Keys keep the image side's batch until the first
        image-to-token update broadcasts them against the P prompts."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(-1, h * w, c).expand_as(keys)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, dtype: torch.dtype | None = None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype) for i, o in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def flatten_convt_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ConvTranspose2d weight (Cin, Cout, 2, 2) -> (Cin, 4 * Cout) GEMM matrix
    with block order (dy, dx, f). A 2x2/stride-2 transposed conv has
    non-overlapping windows, so it is exactly a per-pixel linear map to 4
    sub-pixels: out[2h + dy, 2w + dx, f] = x[h, w, :] @ weight[:, f, dy, dx]."""
    return weight.to(dtype).permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def upscale_linear(x: torch.Tensor, conv: nn.ConvTranspose2d,
                   dtype: torch.dtype) -> torch.Tensor:
    """The per-pixel linear map of `conv` without the depth-to-space
    interleave: (..., Cin) -> (..., 4 * Cout), sub-pixels in (dy, dx, f) order."""
    return F.linear(x.to(dtype), flatten_convt_weight(conv.weight, dtype).t(),
                    conv.bias.to(dtype).repeat(4))


class MaskDecoder(nn.Module):
    def __init__(self, embed_dim: int = 256, num_multimask_outputs: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(embed_dim=embed_dim, dtype=dtype)
        self.iou_token = nn.Embedding(1, embed_dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, embed_dim)
        # upstream's layout; applied below as flat GEMMs, not as convs
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(embed_dim, embed_dim // 4, 2, 2),
            LayerNorm2d(embed_dim // 4),
            nn.GELU(),
            nn.ConvTranspose2d(embed_dim // 4, embed_dim // 8, 2, 2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList([
            MLP(embed_dim, embed_dim, embed_dim // 8, dtype=dtype)
            for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = MLP(embed_dim, embed_dim, self.num_mask_tokens)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool = True):
        """image_embeddings: (1, H, W, C) single-image embedding; image_pe
        (H, W, C) or (1, H, W, C); sparse_prompt: (P, Np, C) for P prompts;
        dense_prompt: (1 or P, H, W, C). Returns (masks (P, M, 4H, 4W)
        float32, iou_pred (P, M))."""
        p = sparse_prompt.shape[0]
        m = self.num_mask_tokens
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(p, -1, -1), sparse_prompt], dim=1)

        # keys keep dense_prompt's batch: with the batch-1 dense of point-only
        # prompting, layer 0's key-side projections run once for all prompts
        src = image_embeddings + dense_prompt
        hs, src = self.transformer(src, image_pe if image_pe.ndim == 4 else image_pe[None],
                                   tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + m]

        h, w = image_embeddings.shape[1:3]
        c4, c8 = self.embed_dim // 4, self.embed_dim // 8
        # both 2x2/s2 transposed convs as flat GEMMs, with the depth-to-space
        # interleave deferred past the hypernetwork contraction: only the
        # (P, M, 4H, 4W) masks are reordered at the end
        convt1, ln, gelu, convt2, _ = self.output_upscaling
        up = upscale_linear(src.reshape(p, h * w, self.embed_dim), convt1, self.dtype)
        up = gelu(ln(up.reshape(p, h * w * 4, c4)))        # blocks (dy, dx)
        up = gelu(upscale_linear(up, convt2, self.dtype))  # (P, HW * 4, 4 * C/8)
        up = up.reshape(p, h * w * 16, c8)                 # blocks (dy, dx, gy, gx)

        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)], dim=1)
        # float32 accumulation and result, as the JAX einsum asks for
        masks = hyper_in.float() @ up.float().transpose(1, 2)          # (P, M, HW * 16)
        # position = (((h * W + w) * 2 + dy) * 2 + dx) * 4 + (gy * 2 + gx):
        # interleave to rows 4h + 2dy + gy, cols 4w + 2dx + gx
        masks = masks.reshape(p, m, h, w, 2, 2, 2, 2).permute(0, 1, 2, 4, 6, 3, 5, 7)
        masks = masks.reshape(p, m, 4 * h, 4 * w)
        iou_pred = self.iou_prediction_head(iou_token_out)

        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
