"""Training-loop observability hooks: JSON scalar log + in-training eval.

Counterpart of the JAX package's ``utils/log_hooks.py`` (the reference's
mmcv hooks, configs/MSMDFusion_nusc_voxel_LC.py:295-299 ``log_config`` /
``evaluation``):

- ``JsonLogWriter`` mirrors mmcv's TextLoggerHook JSON output
  (``<work_dir>/<timestamp>.log.json``): one JSON object per line with
  ``mode``/``epoch``/``iter`` plus scalars;
- ``EvalHook`` runs validation every N epochs (reference
  ``evaluation = dict(interval=1)``) with a batch inference function and
  the dataset's own ``evaluate``; the rows dropped at every capacity site
  during it (pipeline and model) go into the record as
  ``overflow/<site>``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from . import overflow


class JsonLogWriter:
    """Append-only line-JSON scalar log (mmcv TextLoggerHook format)."""

    def __init__(self, work_dir: str, filename: Optional[str] = None):
        os.makedirs(work_dir, exist_ok=True)
        name = filename or f'{time.strftime("%Y%m%d_%H%M%S")}.log.json'
        self.path = os.path.join(work_dir, name)

    def write(self, mode: str, epoch: int, step: int,
              scalars: Dict[str, float], **extra) -> None:
        rec = dict(mode=mode, epoch=int(epoch), iter=int(step))
        rec.update({k: (float(v) if hasattr(v, '__float__') else v)
                    for k, v in scalars.items()})
        rec.update(extra)
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec) + '\n')


class EvalHook:
    """Run dataset evaluation every ``interval`` epochs during training.

    Args:
        dataset: a built val dataset with ``evaluate(results)``.
        infer_fn: callable(batch) -> list of per-sample detection dicts.
        interval: epochs between evaluations (reference EvalHook.interval).
        max_samples: cap on val samples (None = all).
        num_workers, device: the val loader's (``datasets.DataLoader``).
    """

    def __init__(self, dataset, infer_fn: Callable,
                 interval: int = 1, max_samples: Optional[int] = None,
                 num_workers: int = 0, device=None):
        self.dataset = dataset
        self.infer_fn = infer_fn
        self.interval = max(int(interval), 1)
        self.max_samples = max_samples
        self.num_workers = num_workers
        self.device = device

    def should_run(self, epoch: int) -> bool:
        return (epoch + 1) % self.interval == 0

    def run(self) -> Dict[str, float]:
        from ..datasets.loader import DataLoader
        results = []
        with overflow.capture() as cap, DataLoader(
                self.dataset, 1, shuffle=False, drop_last=False,
                num_workers=self.num_workers, device=self.device) as loader:
            for i, batch in enumerate(loader):
                if self.max_samples is not None and i >= self.max_samples:
                    break
                results.extend(self.infer_fn(batch))
        metrics = self.dataset.evaluate(results)
        out = {k: float(v) for k, v in metrics.items()
               if hasattr(v, '__float__') or isinstance(v, (int, float))}
        for site, count in cap.counters().items():
            out[f'overflow/{site}'] = float(count)
        return out
