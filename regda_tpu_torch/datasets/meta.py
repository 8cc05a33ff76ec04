"""Dataset metadata registry.

The port's copy of regda_tpu/datasets/meta.py: the port imports nothing of the JAX package.

Parity targets: regda/datasets/isprsda.py:17-43 (IsprsDA: 6 classes, 512
tiles, ignore -1, offset 0) and regda/datasets/loveda.py:17-46 (LoveDA: 7
classes, 1024 tiles, offset -1 so png ids 0..7 -> -1..6).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class DatasetMeta:
    name: str
    label_map: "OrderedDict[str, int]"
    color_map: "OrderedDict[str, tuple]"
    size: tuple[int, int]
    ignore_label: int
    offset: int

    @property
    def num_classes(self) -> int:
        return len(self.label_map)

    @property
    def palette(self) -> list[int]:
        return np.asarray(list(self.color_map.values())).reshape((-1,)).tolist()

    @property
    def class_names(self) -> list[str]:
        return list(self.color_map.keys())


IsprsDA = DatasetMeta(
    name='IsprsDA',
    label_map=OrderedDict(BgClutter=0, imp_surf=1, building=2, low_vege=3,
                          tree=4, car=5),
    color_map=OrderedDict(BgClutter=(255, 0, 0), imp_surf=(255, 255, 255),
                          building=(0, 0, 255), low_vege=(0, 255, 255),
                          tree=(0, 255, 0), car=(255, 255, 0)),
    size=(512, 512),
    ignore_label=-1,
    offset=0,
)

LoveDA = DatasetMeta(
    name='LoveDA',
    label_map=OrderedDict(Backgd=0, Building=1, Road=2, Water=3, Barren=4,
                          Forest=5, Agricult=6),
    color_map=OrderedDict(Backgd=(255, 255, 255), Building=(255, 0, 0),
                          Road=(255, 255, 0), Water=(0, 0, 255),
                          Barren=(159, 129, 183), Forest=(0, 255, 0),
                          Agricult=(255, 195, 128)),
    size=(1024, 1024),
    ignore_label=-1,
    offset=-1,
)

DATASETS = {'IsprsDA': IsprsDA, 'LoveDA': LoveDA}


def get_meta(name: str) -> DatasetMeta:
    return DATASETS[name]
