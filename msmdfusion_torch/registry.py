"""Lightweight type registries for config-driven model assembly.

Private copy of the JAX package's ``registry.py``. Re-design of the mmdet3d
registry/builder indirection
(reference: mmdet3d/models/registry.py:1-5, mmdet3d/models/builder.py:1-63).
Unlike mmcv's Registry, this one is a plain dict wrapper: a config dict
``{'type': 'Name', **kwargs}`` resolves to ``REGISTRY['Name'](**kwargs)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps a string name to a class or factory callable."""

    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register(self, name: Optional[str] = None, *, cls: Optional[Callable] = None):
        """Use as decorator ``@REG.register()`` or direct ``REG.register('X', cls=X)``."""
        if cls is not None:
            self._registry[name or cls.__name__] = cls
            return cls

        def _decorator(obj):
            self._registry[name or obj.__name__] = obj
            return obj

        return _decorator

    def get(self, name: str) -> Callable:
        if name not in self._registry:
            raise KeyError(
                f"'{name}' is not registered in registry '{self.name}'. "
                f"Available: {sorted(self._registry)}")
        return self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def keys(self):
        return self._registry.keys()

    def build(self, cfg: Dict[str, Any], **default_kwargs):
        """Instantiate from a config dict with a 'type' key."""
        if cfg is None:
            return None
        if not isinstance(cfg, dict) or 'type' not in cfg:
            raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
        cfg = dict(cfg)
        obj_type = cfg.pop('type')
        kwargs = {**default_kwargs, **cfg}
        return self.get(obj_type)(**kwargs)


DETECTORS = Registry('detectors')
BACKBONES = Registry('backbones')
NECKS = Registry('necks')
HEADS = Registry('heads')
MIDDLE_ENCODERS = Registry('middle_encoders')
BBOX_CODERS = Registry('bbox_coders')
