"""BuildChange building roofs and Cityscapes instances, COCO format.

Port of `aidet_tpu/data/buildchange.py:12-20` on the port's
`CocoDataset`: the same COCO-format JSON (roof or footprint polygons),
with their class names.
"""

from __future__ import annotations

from ..core.eval.class_names import BUILDCHANGE_CLASSES
from .coco import CocoDataset


class BuildChangeDataset(CocoDataset):
    CLASSES = BUILDCHANGE_CLASSES


class CityscapesDataset(CocoDataset):
    """Cityscapes instances in COCO format (parity:
    mmdet/datasets/cityscapes.py)."""
    CLASSES = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")
