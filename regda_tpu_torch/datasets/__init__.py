"""Datasets of the port: metadata, the tile dataset, the host loader and the
device-resident data path (copies of regda_tpu/datasets/{meta,basedata,
loader,device_data}.py). `make_loader` gives a training split's loader: the
host DALoader, or a DeviceLoader where device data is on."""

from regda_tpu_torch.datasets.basedata import TileDataset
from regda_tpu_torch.datasets.device_data import (DeviceCacheTooLarge, DeviceEvalSet,
                                                  DeviceLoader, device_data_enabled,
                                                  eval_loader, get_eval_set, make_loader)
from regda_tpu_torch.datasets.loader import DALoader, InfiniteIterator
from regda_tpu_torch.datasets.meta import DATASETS, IsprsDA, LoveDA, get_meta

__all__ = ['DATASETS', 'DALoader', 'DeviceCacheTooLarge', 'DeviceEvalSet', 'DeviceLoader',
           'InfiniteIterator', 'IsprsDA', 'LoveDA', 'TileDataset', 'device_data_enabled',
           'eval_loader', 'get_eval_set', 'get_meta', 'make_loader']
