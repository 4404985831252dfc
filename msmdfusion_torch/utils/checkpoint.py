"""Checkpoints: the port's own files, and reference mmdet3d ``.pth`` files.

Counterpart of the JAX package's ``utils/checkpoint.py`` (reference mmcv
CheckpointHook / load_checkpoint: ``checkpoint_config interval=1``,
tools/train.py:262-268 meta, ``resume_from`` vs ``load_from``). A
checkpoint is one ``torch.save`` file, ``<work_dir>/ckpt_<step>`` as the
JAX package names its checkpoints, holding ``{state_dict, optimizer, step,
meta}``.

``load_checkpoint`` also reads a reference mmdet3d ``.pth``: the port's
parameters carry the reference key names, so its ``state_dict`` loads as
it is (the port's counterpart of the JAX package's
``torch_convert.load_torch_checkpoint`` + ``convert_msmdfusion``). Keys
such a file lacks that have no reference counterpart (the GMA
``dummy_embedding_{i}``, ``torch_convert.py:330-333``) keep their current
values, as ``merge_variables`` keeps the initial ones, and are listed in a
warning; any other missing or unexpected key raises.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, Optional

import torch
from torch import nn

_NAME = re.compile(r'^ckpt_(\d+)$')
# parameters the reference checkpoints have no key for
_NO_REFERENCE_KEY = re.compile(r'(^|\.)dummy_embedding_\d+$')


def save_checkpoint(work_dir: str, step: int, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``{state_dict, optimizer, step, meta}`` (tensors on the CPU)
    to ``<work_dir>/ckpt_<step>``; returns the path."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(work_dir, f'ckpt_{step}'))
    state = {'state_dict': {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
             'step': int(step), 'meta': dict(meta or {})}
    if optimizer is not None:
        state['optimizer'] = optimizer.state_dict()
    tmp = path + '.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: Optional[nn.Module] = None
                    ) -> Dict[str, Any]:
    """The checkpoint at ``path`` as a dict (a file of bare tensors is taken
    as its ``state_dict``); with ``model``, its ``state_dict`` is loaded
    into it (see the module docstring for missing keys)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' not in ckpt:
        ckpt = {'state_dict': ckpt}
    if model is not None:
        missing, unexpected = model.load_state_dict(ckpt['state_dict'],
                                                    strict=False)
        kept = [k for k in missing if _NO_REFERENCE_KEY.search(k)]
        missing = [k for k in missing if k not in kept]
        unexpected = [k for k in unexpected
                      if not k.endswith('num_batches_tracked')]
        if missing or unexpected:
            raise KeyError(f'{path}: state_dict does not match the model: '
                           f'missing {missing}, unexpected {unexpected}')
        if kept:
            warnings.warn(f'{path} has no value for {kept}: they keep their '
                          'current values', stacklevel=2)
    return ckpt


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The ``ckpt_<step>`` of ``work_dir`` with the largest step, if any."""
    if not os.path.isdir(work_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(work_dir))
             if m]
    if not steps:
        return None
    return os.path.join(work_dir, f'ckpt_{max(steps)}')
