"""Hand-written Hopper kernels, each with its plain PyTorch version beside it.

| module | replaces (TPU kernel) | source |
| --- | --- | --- |
| `segment_hist` | `regda_tpu/ops/pallas/segment_hist.py` | `csrc/segment_hist.cu` |
| `layernorm` | `regda_tpu/models/sam/pallas_ln.py` | `csrc/layernorm.cu` |
| `rel_attention` | `regda_tpu/models/sam/pallas_attention.py` | `csrc/rel_attention.cu` |
"""
