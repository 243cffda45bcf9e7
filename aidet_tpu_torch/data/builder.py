"""Dataset registry and builder.

Port of `aidet_tpu/data/builder.py::build_dataset` (:22; parity:
mmdet/datasets/builder.py:47-59) through the port's
`utils/registry.py`, with `CocoDataset` and `DOTADataset`.  The
reference's other datasets and its wrappers (`RepeatDataset`, a list as
`ConcatDataset`) raise `KeyError`: not yet ported (ROADMAP queue 1
item 11).
"""

from __future__ import annotations

from ..utils.registry import Registry, build_from_cfg
from .coco import CocoDataset
from .dota import DOTADataset

NOT_PORTED = "not yet ported to aidet_tpu_torch"

DATASETS = Registry("dataset")
DATASETS.register(CocoDataset)
DATASETS.register(DOTADataset)


def build_dataset(cfg, default_args=None):
    """The dataset of a ``dict(type=..., ...)`` config."""
    if isinstance(cfg, (list, tuple)):
        raise KeyError(f"ConcatDataset (a list of dataset configs) is "
                       f"{NOT_PORTED}")
    kind = cfg.get("type")
    if isinstance(kind, str) and DATASETS.get(kind) is None:
        raise KeyError(f"dataset {kind} is {NOT_PORTED}")
    return build_from_cfg(cfg, DATASETS, default_args)
