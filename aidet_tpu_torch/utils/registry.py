"""Minimal registry + config-dict builder.

Keeps the reference's declarative ``dict(type='ClassName', ...)``
config convention (mmdet/utils/registry.py:7-79) so configs read the
same.  A copy of `aidet_tpu/utils/registry.py`; here the registered
objects build torch modules (`aidet_tpu_torch.models.builder`).
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: dict[str, type] = {}

    def __repr__(self):
        return (f"{self.__class__.__name__}(name={self._name}, "
                f"items={list(self._module_dict)})")

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def register(self, cls=None, *, name: str | None = None):
        """Use as ``@REG.register`` or ``@REG.register(name='X')``."""
        def _do(c):
            key = name or c.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = c
            return c
        if cls is None:
            return _do
        return _do(cls)

    # familiar alias
    register_module = register


def build_from_cfg(cfg: dict, registry: Registry, default_args=None):
    """Instantiate from a ``dict(type=..., **kwargs)`` config.

    Parity: mmdet/utils/registry.py:51-79 (build_from_cfg).
    """
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with 'type', got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(
                f"{obj_type} is not in the {registry.name} registry "
                "of aidet_tpu_torch: not yet ported")
    elif inspect.isclass(obj_type) or callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
