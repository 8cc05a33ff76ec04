"""Hand-written Hopper kernels, each with its plain PyTorch version beside it.

| module | replaces (TPU kernel) | source |
| --- | --- | --- |
| `segment_hist` | `regda_tpu/ops/pallas/segment_hist.py` | `csrc/segment_hist.cu` |
| `layernorm` | `regda_tpu/models/sam/pallas_ln.py` | `csrc/layernorm.cu` |
| `rel_attention` | `regda_tpu/models/sam/pallas_attention.py` | `csrc/rel_attention.cu` |

Each public wrapper's call, on either route (the CUDA kernel or the plain
version), is the span `kernel.<name>` in an active profiler's trace
(`kernel.segment_hist`, `kernel.layernorm`, `kernel.rel_attention`,
`kernel.two_way`, `kernel.upscale`, `kernel.stability_blocked`,
`kernel.stability_fused`, `kernel.mask_stats`; utils/profiling.py:span),
beside the module's `launches` counter.
"""
