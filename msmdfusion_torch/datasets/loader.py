"""Data loader: worker processes -> pinned batches -> the device.

Counterpart of the JAX package's ``datasets/loader.py`` (reference mmdet
``build_dataloader``, ``workers_per_gpu``), built on
``torch.utils.data.DataLoader``:

- the numpy pipeline runs in worker *processes* (torch's default start
  method, one torch thread each, CPU work only: no CUDA in a worker), so
  it does not contend for the interpreter lock with the host-bound model;
  ``num_workers=0`` runs it in the calling process;
- every sample draws from its own ``np.random.RandomState`` seeded from
  (seed, epoch, index), so the batches do not depend on the number of
  workers; the dataset's ``set_epoch`` (the pipeline's fades) is called
  with the sample's epoch where it runs, in the worker, whose copy of the
  dataset the caller's ``set_epoch`` never reaches;
- the batch order of an epoch is the JAX loader's: the indices shuffled by
  ``np.random.RandomState(seed + epoch)`` (``set_epoch``), so a resumed run
  sees the order a fresh one would;
- over ``world`` ranks, every rank draws the same order and loads its
  share of each global batch of ``batch_size x world`` samples, the
  contiguous slice ``rank`` (each JAX process's share of a batch-sharded
  global batch); at world 1 the loader is the single-process one.
  ``indices`` restricts the loader to some dataset indices (an eval
  rank's ``shard_indices``), each sample still seeded by its own index;
- fixed shapes make collation a plain stack; batches are pinned and moved
  to ``device`` with non-blocking copies, the foreground dict included
  (``metas`` stays on the host);
- the rows a pipeline drops at a capacity (``PadPoints``,
  ``PadForeground2D``) are counted in the worker and recorded again, under
  the same sites, in the caller's ``overflow.capture()`` scope.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel.distributed import local_batch_slice
from ..utils import overflow


def collate(samples: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Stack fixed-shape sample dicts into batch tensors; metas -> list.
    ``None`` samples are left out (None if none is left)."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        if key == 'metas':
            batch['metas'] = [s['metas'] for s in samples]
        elif key == 'foreground':
            fg = {}
            for fk in samples[0]['foreground']:
                vals = [s['foreground'][fk] for s in samples]
                fg[fk] = (torch.from_numpy(np.stack(vals))
                          if isinstance(vals[0], np.ndarray) else vals[0])
            batch['foreground'] = fg
        else:
            batch[key] = torch.from_numpy(np.stack([s[key] for s in samples]))
    return batch


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Every tensor of ``batch`` (nested dicts included) on ``device``,
    copied without blocking; ``metas`` stays as it is."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x
    return {k: v if k == 'metas' else move(v) for k, v in batch.items()}


class _Samples(torch.utils.data.Dataset):
    """``dataset.sample(index, rng)`` for keys (index, epoch), with the
    generator seeded from (seed, epoch, index) and the dataset at that
    epoch (``set_epoch``, where it has one), and the overflow counts of
    the pipeline's capacity sites."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        index, epoch = key
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)
        rng = np.random.RandomState([self.seed, epoch, index])
        with overflow.capture() as cap:
            sample = self.dataset.sample(index, rng)
        return sample, cap.counters()


def _collate_counted(items):
    counts: Dict[str, int] = {}
    for _, c in items:
        for site, n in c.items():
            counts[site] = counts.get(site, 0) + n
    return collate([s for s, _ in items]), counts


class _EpochBatches:
    """Batch sampler: the loader's batches of the current epoch, each
    index keyed with the epoch."""

    def __init__(self, loader: 'DataLoader'):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        epoch = self.loader.epoch
        for idx in self.loader.index_batches():
            yield [(int(i), epoch) for i in idx]


class DataLoader:
    """Batches of ``dataset`` (a dataset with ``sample(index, rng)``),
    pipelines run by ``num_workers`` worker processes; with ``device``,
    pinned and moved there. The workers persist across epochs until
    ``close``. ``rank``/``world``: this rank's ``batch_size`` samples of
    each global batch; ``indices``: the dataset indices to load (all where
    None)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 drop_last: bool = True, device=None, rank: int = 0,
                 world: int = 1, indices=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.device = torch.device(device) if device is not None else None
        self.rank = rank
        self.world = world
        self.indices = (np.arange(len(dataset)) if indices is None
                        else np.asarray(indices, np.int64))
        self.epoch = 0
        self._loader = None

    def set_epoch(self, epoch: int):
        """The epoch whose shuffle, per-sample seeds and pipeline fades
        the next pass uses (DistributedSampler.set_epoch semantics)."""
        self.epoch = epoch

    def __len__(self):
        n, g = len(self.indices), self.batch_size * self.world
        if self.drop_last:
            return n // g
        return -(-n // g)

    def index_batches(self) -> List[np.ndarray]:
        """This rank's batches of dataset indices in the epoch:
        ``RandomState(seed + epoch)`` shuffles the indices where
        ``shuffle``, global batches of ``batch_size x world`` follow in
        order, and the rank takes its slice of each."""
        idx = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        g = self.batch_size * self.world
        mine = local_batch_slice(g, self.rank, self.world)
        return [idx[i * g:(i + 1) * g][mine] for i in range(len(self))]

    def _torch_loader(self):
        if self._loader is None:
            self._loader = torch.utils.data.DataLoader(
                _Samples(self.dataset, self.seed),
                batch_sampler=_EpochBatches(self),
                num_workers=self.num_workers, collate_fn=_collate_counted,
                pin_memory=self.device is not None
                and self.device.type == 'cuda',
                persistent_workers=self.num_workers > 0)
        return self._loader

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch, counts in self._torch_loader():
            for site, n in counts.items():
                overflow.record(site, n)
            if batch is None:
                continue
            yield batch if self.device is None else to_device(batch,
                                                              self.device)

    def close(self) -> None:
        """Stop the worker processes (a later pass starts new ones)."""
        self._loader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
