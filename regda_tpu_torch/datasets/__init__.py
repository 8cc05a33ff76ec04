"""Dataset metadata of the port (a copy of regda_tpu/datasets/meta.py)."""

from regda_tpu_torch.datasets.meta import DATASETS, IsprsDA, LoveDA, get_meta

__all__ = ['DATASETS', 'IsprsDA', 'LoveDA', 'get_meta']
