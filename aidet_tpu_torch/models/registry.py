"""Model registries (parity: mmdet/models/registry.py:3-9; of
`aidet_tpu/models/registry.py`'s, those of the kinds the port has)."""

from ..utils.registry import Registry

BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
SHARED_HEADS = Registry("shared_head")
DETECTORS = Registry("detector")
