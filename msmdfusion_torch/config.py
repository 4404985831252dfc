"""Python-dict config system with `_base_` inheritance and dotted overrides.

Private copy of the JAX package's ``config.py`` (the port imports nothing of
that package). Re-design of mmcv's ``Config.fromfile`` as used by the reference
(configs/*.py with ``_base_`` merging; --cfg-options dotted overrides,
reference: tools/train.py:63-72). Config files are plain Python modules whose
module-level variables become config entries; a ``_base_`` variable (str or
list of str, relative paths) is recursively merged underneath.
"""
from __future__ import annotations

import copy
import importlib.util
import os
import sys
from typing import Any, Dict, Optional, Sequence, Union


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value


def _merge_dicts(base: Dict, override: Dict) -> Dict:
    """Merge `override` on top of `base` recursively.

    A value of ``{'_delete_': True, ...}`` replaces the base value entirely
    (mirrors mmcv's _delete_ semantics).
    """
    merged = dict(base)
    for key, value in override.items():
        if (isinstance(value, dict) and isinstance(merged.get(key), dict)
                and not value.pop('_delete_', False)):
            merged[key] = _merge_dicts(merged[key], value)
        else:
            merged[key] = value
    return merged


def _exec_config_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(filename)
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    spec = importlib.util.spec_from_file_location(
        f'_cfg_{abs(hash(filename))}', filename)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
        cfg = {
            k: v for k, v in vars(module).items()
            if not k.startswith('__') and not callable(v)
            and not isinstance(v, type(sys))
        }
    finally:
        del sys.modules[spec.name]
    return cfg


def load_config(filename: str,
                overrides: Optional[Dict[str, Any]] = None) -> ConfigDict:
    """Load a Python config file, resolving `_base_` inheritance."""
    cfg = _exec_config_file(filename)
    base_files: Union[str, Sequence[str]] = cfg.pop('_base_', [])
    if isinstance(base_files, str):
        base_files = [base_files]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(filename))
    for base in base_files:
        base_cfg = load_config(os.path.join(cfg_dir, base))
        merged = _merge_dicts(merged, base_cfg)
    merged = _merge_dicts(merged, cfg)
    result = ConfigDict._wrap(merged)
    if overrides:
        apply_overrides(result, overrides)
    return result


def _parse_value(text: str) -> Any:
    """Parse a CLI override value: int/float/bool/None/list/str."""
    lowered = text.lower()
    if lowered in ('true', 'false'):
        return lowered == 'true'
    if lowered in ('none', 'null'):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if ',' in text:
        return [_parse_value(t) for t in text.split(',')]
    return text


def apply_overrides(cfg: ConfigDict, overrides: Dict[str, Any]) -> ConfigDict:
    """Apply dotted-key overrides, e.g. {'model.pts_bbox_head.num_proposals': 300}."""
    for dotted, value in overrides.items():
        if isinstance(value, str):
            value = _parse_value(value)
        keys = dotted.split('.')
        node = cfg
        for key in keys[:-1]:
            if isinstance(node, (list, tuple)):
                node = node[int(key)]
            else:
                if key not in node:
                    node[key] = ConfigDict()
                node = node[key]
        last = keys[-1]
        if isinstance(node, (list, tuple)):
            node[int(last)] = ConfigDict._wrap(value)
        else:
            node[last] = ConfigDict._wrap(value)
    return cfg


def parse_cli_overrides(pairs: Sequence[str]) -> Dict[str, str]:
    """Parse ['a.b=1', 'c=2'] into a dict for apply_overrides."""
    out = {}
    for pair in pairs:
        if '=' not in pair:
            raise ValueError(f'override must be key=value, got {pair!r}')
        key, _, value = pair.partition('=')
        out[key] = value
    return out
