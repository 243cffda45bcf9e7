"""Dataset registry and builder.

Port of `aidet_tpu/data/builder.py::build_dataset` (:22-29; parity:
mmdet/datasets/builder.py:47-59) through the port's
`utils/registry.py`: `CocoDataset`, `DOTADataset`, the XML datasets
(`VOCDataset`, `XMLDataset`, `WIDERFaceDataset`), `BuildChangeDataset`
and `CityscapesDataset`; a ``RepeatDataset`` config wraps its
``dataset`` ``times`` times, and a list of configs is their
`ConcatDataset`.
"""

from __future__ import annotations

from ..utils.registry import Registry, build_from_cfg
from .buildchange import BuildChangeDataset, CityscapesDataset
from .coco import CocoDataset
from .dota import DOTADataset
from .voc import (ConcatDataset, RepeatDataset, VOCDataset,
                  WIDERFaceDataset, XMLDataset)

DATASETS = Registry("dataset")
for _cls in (CocoDataset, DOTADataset, VOCDataset, XMLDataset,
             BuildChangeDataset, CityscapesDataset, WIDERFaceDataset):
    DATASETS.register(_cls)


def build_dataset(cfg, default_args=None):
    """The dataset of a ``dict(type=..., ...)`` config, a
    ``RepeatDataset`` config or a list of configs."""
    if isinstance(cfg, dict) and cfg.get("type") == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"], default_args),
                             cfg["times"])
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c, default_args) for c in cfg])
    return build_from_cfg(cfg, DATASETS, default_args)
