"""Fast SAM mask decoder (counterpart of regda_tpu/models/sam/fast_decoder.py):
the decode path that everything-mode takes.

Everything-mode decodes B point prompts against ONE shared image embedding.
The stock two-way transformer (decoder.py) replicates the (T, C) image-token
state per prompt once the first image-to-token update lands, and every later
key-side op streams (B, T, C) tensors through device memory. The functions
here take the port's `MaskDecoder` module (same parameters, segment-
anything's names) and compute the same result through the two fused kernels:

- `two_way_transformer_dense`: the stock twin as a plain function of the
  module, the image side batch-1 until the first image-to-token update.
- `two_way_transformer_fused2`: the prompt-resident kernel
  (ops/kernels/two_way.py) for everything from layer 0's image-to-token
  update to the final attention; the token-local layer-0 query path and
  layer 1's self-attention stay ordinary PyTorch (`_fused_prep`).
- `mask_decoder_fast`: twin of `MaskDecoder.forward` that wires the
  transformer to the fused upscale + hypernetwork mask head
  (ops/kernels/upscale.py), with the everything-mode IoU gate and the
  candidate-major blocked mask layout.

Which implementation a kernel wrapper runs follows from the tensors' device:
the CUDA kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from regda_tpu_torch.models.sam.decoder import (MaskDecoder, TwoWayTransformer,
                                                upscale_linear)
from regda_tpu_torch.ops.kernels.two_way import NP, two_way_fused
from regda_tpu_torch.ops.kernels.upscale import (upscale_hyper_masks,
                                                 upscale_params_from_decoder)


def two_way_transformer_dense(transformer: TwoWayTransformer, image_embedding,
                              image_pe, point_embedding):
    """The stock twin as a plain function: image side (1, H, W, C), shared by
    the prompts of point_embedding (B, N, C) until the first image-to-token
    update. The port's `TwoWayTransformer.forward` already keeps the image
    side's batch until then, so this is that call. Returns (queries
    (B, N, C) float32, keys (B, HW, C))."""
    return transformer(image_embedding, image_pe, point_embedding)


def _fused_prep(transformer: TwoWayTransformer, image_embedding, image_pe,
                point_embedding):
    """The token-local layer-0 query path and layer 1's self-attention in
    ordinary PyTorch, and the operand tuple of `two_way_fused` (see
    ops/kernels/two_way.py). Returns (operands, number of tokens)."""
    b1, h, w, c = image_embedding.shape
    if b1 != 1:
        raise ValueError('fused two-way requires a shared (batch-1) image embedding')
    t = h * w
    l0, l1 = transformer.layers
    dt = l0.self_attn.q_proj.compute_dtype
    keys0 = image_embedding.reshape(t, c).to(dt)
    key_pe = image_pe.reshape(-1, t, c)[0].to(dt)
    qpe = point_embedding.to(dt)
    n = qpe.shape[1]
    if n > NP:
        raise ValueError(f'two_way_fused supports <= {NP} tokens, got {n}')

    # ---- layer 0 query path on the SHARED keys (token-local + batch-1) ----
    queries = l0.norm1(l0.self_attn(qpe, qpe, qpe)).to(dt)
    k = (keys0 + key_pe)[None]
    queries = queries + l0.cross_attn_token_to_image(queries + qpe, k, keys0[None])
    queries = l0.norm2(queries).to(dt)
    queries = l0.norm3(queries + l0.mlp(queries)).to(dt)
    i2t0 = l0.cross_attn_image_to_token
    ktok0 = i2t0.k_proj(queries + qpe)                     # (B, N, D)
    vtok0 = i2t0.v_proj(queries)
    qimg0 = i2t0.q_proj(keys0 + key_pe)                    # (T, D)

    # ---- layer 1 self-attention + norm1 (token-local) ---------------------
    q = queries + qpe
    queries1 = l1.norm1(queries + l1.self_attn(q, q, queries)).to(dt)

    def padf(x):
        return F.pad(x, (0, 0, 0, NP - n))
    maskb = torch.where(torch.arange(NP, device=qpe.device) < n, 0.0, -1e9)[None].float()
    t2i1, i2t1 = l1.cross_attn_token_to_image, l1.cross_attn_image_to_token
    fat = transformer.final_attn_token_to_image
    weights = {'wo0': i2t0.out_proj.weight.t(), 'bo0': i2t0.out_proj.bias,
               'w1': l1.mlp.lin1.weight.t(), 'b1': l1.mlp.lin1.bias,
               'w2': l1.mlp.lin2.weight.t(), 'b2': l1.mlp.lin2.bias}
    for tag, attn in (('t', t2i1), ('i', i2t1), ('f', fat)):
        for p in 'qkvo':
            proj = getattr(attn, f'{p}_proj' if p != 'o' else 'out_proj')
            weights['w' + p + tag], weights['b' + p + tag] = proj.weight.t(), proj.bias
    for key, norm in (('n40', l0.norm4), ('n2', l1.norm2), ('n3', l1.norm3),
                      ('n41', l1.norm4), ('nf', transformer.norm_final_attn)):
        weights[key + 'w'], weights[key + 'b'] = norm.weight, norm.bias
    operands = (padf(ktok0), padf(vtok0), padf(queries1), padf(qpe),
                keys0, key_pe, qimg0, maskb, weights)
    return operands, n


def two_way_transformer_fused2(transformer: TwoWayTransformer, image_embedding,
                               image_pe, point_embedding):
    """`two_way_transformer_dense` with the whole prompt-resident core in the
    fused kernel. Same math; needs a batch-1 image embedding. Returns
    (queries (B, N, C), keys (B, HW, C)), both in the compute dtype."""
    operands, n = _fused_prep(transformer, image_embedding, image_pe, point_embedding)
    num_heads = transformer.layers[0].cross_attn_image_to_token.num_heads
    keys2, qout = two_way_fused(operands, num_heads)
    return qout[:, :n], keys2


def mask_decoder_fast(decoder: MaskDecoder, image_embeddings, image_pe, sparse_prompt,
                      dense_prompt, multimask_output: bool = True,
                      fused_upscale: bool = True, mask_dtype=None,
                      iou_gate_thresh=None, blocked_masks: bool = False):
    """Twin of `MaskDecoder.forward` on the same module, the decode that
    everything-mode takes:

    - fused_upscale=True: the fused two-way kernel and the fused upscale +
      hypernetwork mask head; False: the stock dense transformer and flat
      GEMMs (the twins the kernels are held against).
    - iou_gate_thresh: prompts whose every returned IoU fails the threshold
      skip the mask head and return zero masks (the caller drops those
      candidates by the same IoU array, which is computed before the mask
      head; inference-only).
    - blocked_masks: return masks in the candidate-major blocked layout
      (B, M * 16, HW), see `masks_from_blocked`, instead of (B, M, 4H, 4W).
    - mask_dtype: dtype of the returned masks (float32 by default).

    image_embeddings and dense_prompt must be batch-1, shared by the B
    sparse prompts. The compute dtype is the module's. Returns (masks,
    iou_pred (B, M) float32)."""
    m_all = decoder.num_mask_tokens
    b = sparse_prompt.shape[0]
    dt = decoder.dtype
    output_tokens = torch.cat([decoder.iou_token.weight, decoder.mask_tokens.weight], dim=0)
    tokens = torch.cat([output_tokens[None].expand(b, -1, -1).to(sparse_prompt.dtype),
                        sparse_prompt], dim=1)
    src_shared = image_embeddings + dense_prompt[:1]
    pe = image_pe if image_pe.ndim == 4 else image_pe[None]
    transformer = two_way_transformer_fused2 if fused_upscale else two_way_transformer_dense
    hs, src = transformer(decoder.transformer, src_shared, pe, tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + m_all]

    h, w = image_embeddings.shape[1:3]
    c = src.shape[-1]
    # only the masks the caller keeps: multimask drops mask 0
    sel = list(range(1, m_all)) if multimask_output else [0]
    hyper_in = torch.stack([decoder.output_hypernetworks_mlps[i](mask_tokens_out[:, i])
                            for i in sel], dim=1)
    src = src.expand(b, -1, -1).reshape(b, h, w, c)
    mask_dtype = mask_dtype or torch.float32
    # the IoU head reads only the transformer's output: computed before the
    # mask head, in float32, so that the gate and the caller's filter read
    # one array
    iou_pred = decoder.iou_prediction_head(iou_token_out.float())
    if fused_upscale:
        active = None
        if iou_gate_thresh is not None and multimask_output:
            active = (iou_pred[:, 1:] > iou_gate_thresh).any(dim=1)
        masks = upscale_hyper_masks(src.to(dt).contiguous(), hyper_in,
                                    *upscale_params_from_decoder(decoder, dt),
                                    out_dtype=mask_dtype, active=active,
                                    blocked=blocked_masks)
    else:
        c4, c8 = c // 4, c // 8
        convt1, ln, gelu, convt2, _ = decoder.output_upscaling
        up = upscale_linear(src.reshape(b, h * w, c), convt1, dt)
        up = gelu(ln(up.reshape(b, h * w * 4, c4)))
        up = gelu(upscale_linear(up, convt2, dt))
        up = up.reshape(b, h * w * 16, c8)               # blocks (dy, dx, gy, gx)
        masks = hyper_in.float() @ up.float().transpose(1, 2)      # (B, M, HW * 16)
        if blocked_masks:
            masks = (masks.reshape(b, len(sel), h * w, 16).transpose(2, 3)
                     .reshape(b, len(sel) * 16, h * w).to(mask_dtype))
        else:
            masks = masks.reshape(b, len(sel), h, w, 2, 2, 2, 2).permute(0, 1, 2, 4, 6, 3, 5, 7)
            masks = masks.reshape(b, len(sel), 4 * h, 4 * w).to(mask_dtype)
    if multimask_output:
        return masks, iou_pred[:, 1:]
    return masks, iou_pred[:, :1]
