"""Datasets of the port: metadata, the tile dataset and the host loader
(copies of regda_tpu/datasets/{meta,basedata,loader}.py)."""

from regda_tpu_torch.datasets.basedata import TileDataset
from regda_tpu_torch.datasets.loader import DALoader, InfiniteIterator, make_loader
from regda_tpu_torch.datasets.meta import DATASETS, IsprsDA, LoveDA, get_meta

__all__ = ['DATASETS', 'DALoader', 'InfiniteIterator', 'IsprsDA', 'LoveDA',
           'TileDataset', 'get_meta', 'make_loader']
