"""Python-file config loader with attribute access.

Replaces mmcv.Config.fromfile (used at tools/train.py:67 in the
reference): a config is a plain Python file whose module-level
variables become config entries; nested dicts get attribute access.
A copy of `aidet_tpu/utils/config.py`: both packages read the same
config files.
"""

from __future__ import annotations

import importlib.util
import os


class ConfigDict(dict):
    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v


def _wrap(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v) for v in obj)
    return obj


def _merge_dicts(base: dict, override: dict) -> dict:
    """Recursive override merge (mmcv Config._merge_a_into_b parity):
    dict values merge key-by-key; anything else replaces.  A dict
    override carrying ``_delete_: True`` replaces the base dict
    wholesale instead of merging."""
    out = dict(base)
    for k, v in override.items():
        if (isinstance(v, dict) and isinstance(out.get(k), dict)
                and not v.get("_delete_")):
            out[k] = _merge_dicts(out[k], v)
        else:
            if isinstance(v, dict):
                v = _strip_delete(v)
            out[k] = v
    return out


def _strip_delete(d: dict) -> dict:
    """Drop _delete_ markers RECURSIVELY on the replace path — a nested
    marker would otherwise leak into build_from_cfg as a constructor
    kwarg, failing far from the config that caused it."""
    return {k: (_strip_delete(v) if isinstance(v, dict) else v)
            for k, v in d.items() if k != "_delete_"}


class Config:
    """cfg = Config.fromfile('configs/faster_rcnn_r50_fpn.py')

    A config file may set ``_base_`` to a path (or list of paths,
    relative to itself); base configs load first and the file's own
    variables override them with a recursive dict merge — variant
    configs then only state their deltas."""

    def __init__(self, cfg_dict: dict, filename: str | None = None):
        self._cfg = _wrap(cfg_dict)
        self.filename = filename

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        spec = importlib.util.spec_from_file_location("_aidet_cfg", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = {k: v for k, v in vars(mod).items()
               if not k.startswith("__") and k != "_base_"
               and not callable(v)
               and not isinstance(v, type(importlib))}
        base = getattr(mod, "_base_", None)
        if base:
            merged: dict = {}
            for b in ([base] if isinstance(base, str) else base):
                bpath = os.path.join(os.path.dirname(path), b)
                merged = _merge_dicts(merged,
                                      cls.fromfile(bpath).to_dict())
            cfg = _merge_dicts(merged, cfg)
        return cls(cfg, path)

    def __getattr__(self, k):
        if k.startswith("_") or k == "filename":
            raise AttributeError(k)
        try:
            return self._cfg[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __contains__(self, k):
        return k in self._cfg

    def get(self, k, default=None):
        return self._cfg.get(k, default)

    def keys(self):
        return self._cfg.keys()

    @property
    def text(self):
        if self.filename and os.path.exists(self.filename):
            with open(self.filename) as f:
                return f.read()
        return repr(self._cfg)

    def to_dict(self):
        return dict(self._cfg)
