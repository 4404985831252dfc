"""Process groups, rank-sharded data and cross-rank results.

Counterpart of the JAX package's ``parallel/distributed.py`` (reference
``init_dist(launcher, backend='nccl')``, tools/dist_train.sh,
mmdet's ``DistributedGroupSampler`` and ``collect_results_cpu``):

- ``init_dist(launcher, device)`` joins the process group: ``none`` is a
  single process; ``pytorch`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the counterpart of
  the JAX package's TPU runtime discovery); ``manual`` reads
  ``MSMD_COORDINATOR`` (host:port), ``MSMD_NUM_PROCESSES`` and
  ``MSMD_PROCESS_ID`` as the JAX package does. The backend is NCCL on the
  card, each rank on ``cuda:LOCAL_RANK``, and gloo where the caller asks
  for the CPU. A launcher that was asked for and fails raises: there is no
  silent single-process fallback.
- ``all_sum`` is the sum over the group that carries autograd (its
  gradient is the group's sum of the gradients), the identity without a
  group: the batch norms' moments, the head's loss normalisers and the
  train step's gradients are global through it, as GSPMD makes the JAX
  package's reductions over a batch-sharded mesh; ``rank_offset`` (where
  this rank's rows start in the global batch's: the GMA's
  representatives) and ``gather_rows`` (the global batch's rows on every
  rank: the head's classification weights) are built on it.
- ``local_batch_slice``, ``shard_indices``, ``collect_results`` and
  ``merge_sharded_results`` shard data and gather results over ranks;
  ``rank`` and ``world`` are explicit where the JAX functions read the
  process index.
- ``SharedGenerator``: dropout drawn from one generator over the global
  batch, each rank keeping its own rows (the JAX package's single key).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

LAUNCHERS = ('none', 'pytorch', 'manual')


def grouped() -> bool:
    """True inside a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if grouped() else 0


def get_world_size() -> int:
    return dist.get_world_size() if grouped() else 1


def check_launcher(launcher: str) -> None:
    """``launcher`` must be one of ``LAUNCHERS``: ``none`` (one process),
    ``pytorch`` (torchrun's environment) or ``manual``
    (``MSMD_COORDINATOR``, ``MSMD_NUM_PROCESSES``, ``MSMD_PROCESS_ID``)."""
    if launcher not in LAUNCHERS:
        raise ValueError(f'--launcher {launcher}: one of '
                         f'{", ".join(LAUNCHERS)}')


def _env(names: Sequence[str], launcher: str) -> List[str]:
    missing = [n for n in names if n not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher {launcher}: {", ".join(missing)} not '
                           'set in the environment')
    return [os.environ[n] for n in names]


def init_dist(launcher: str = 'none', device='cuda',
              backend: Optional[str] = None) -> torch.device:
    """Join the process group of ``launcher`` (one of ``LAUNCHERS``) and
    return this rank's device. ``device``: ``cuda`` (the rank's card,
    ``cuda:LOCAL_RANK``; for ``manual``, the process id modulo the visible
    cards), an explicit ``cuda:N``, or ``cpu``. ``backend`` defaults to
    NCCL on the card and gloo on the CPU (gloo on the card serves ranks
    that share one card, which NCCL refuses). ``none`` joins nothing."""
    from ..models.builder import resolve_device
    check_launcher(launcher)
    dev = resolve_device(device)
    if launcher == 'none':
        return dev
    if grouped():
        raise RuntimeError('init_dist: this process is already in a process '
                           'group')
    if launcher == 'pytorch':
        rank, world, local = map(int, _env(
            ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'), launcher))
        _env(('MASTER_ADDR', 'MASTER_PORT'), launcher)
        init_method = 'env://'
    else:
        coordinator, world, rank = _env(
            ('MSMD_COORDINATOR', 'MSMD_NUM_PROCESSES', 'MSMD_PROCESS_ID'),
            launcher)
        world, rank = int(world), int(rank)
        local = rank % max(torch.cuda.device_count(), 1)
        init_method = f'tcp://{coordinator}'
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', local)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
        init_method=init_method, rank=rank, world_size=world)
    return dev


@contextlib.contextmanager
def dist_scope(launcher: str, device='cuda',
               backend: Optional[str] = None) -> Iterator[torch.device]:
    """``init_dist`` for the body of a ``with``; the group it joined is
    left on exit."""
    dev = init_dist(launcher, device, backend)
    try:
        yield dev
    finally:
        if launcher != 'none' and grouped():
            dist.destroy_process_group()


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the group (a new tensor; on the
    device, no host sync), differentiable: its gradient is the sum of the
    ranks' gradients. Without a group, ``x`` itself."""
    return _AllSum.apply(x) if grouped() else x


def rank_offset(n: torch.Tensor) -> torch.Tensor:
    """The sum of ``n`` (a 0-d tensor) over the ranks before this one: the
    position of this rank's first row in the global batch's rows (0 without
    a group; on ``n``'s device, no host sync)."""
    if not grouped():
        return torch.zeros_like(n)
    mine = torch.zeros(get_world_size(), dtype=n.dtype, device=n.device)
    mine[get_rank()] = n
    return all_sum(mine)[:get_rank()].sum()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along the
    leading axis in rank order: the global batch's rows, on every rank
    (``x`` itself without a group; not differentiable)."""
    if not grouped():
        return x
    out = x.new_zeros((get_world_size(), *x.shape))
    out[get_rank()] = x
    return all_sum(out).reshape(-1, *x.shape[1:])


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s (a no-op without
    a group)."""
    if grouped():
        for t in tensors:
            dist.broadcast(t, src)


def local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous slice of a global batch split over
    ``world`` ranks (the batch must divide evenly)."""
    if global_batch % world:
        raise ValueError(f'a global batch of {global_batch} does not split '
                         f'over {world} ranks')
    per = global_batch // world
    return slice(per * rank, per * (rank + 1))


def shard_indices(num_samples: int, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s dataset indices for evaluation: every ``world``-th
    from ``rank`` on."""
    return np.arange(rank, num_samples, world)


def collect_results(local_results: List[Any]) -> List[Tuple[int, List[Any]]]:
    """Every rank's result list, as ``(rank, results)`` pairs in rank
    order, on every rank (``all_gather_object``; ``[(0, local_results)]``
    without a group)."""
    if not grouped():
        return [(0, local_results)]
    gathered: List[Any] = [None] * get_world_size()
    dist.all_gather_object(gathered, local_results)
    return list(enumerate(gathered))


def merge_sharded_results(collected, num_samples: int) -> List[Any]:
    """Rank-sharded results (``collect_results``) back in dataset order."""
    merged: List[Any] = [None] * num_samples
    for rank, results in collected:
        idx = shard_indices(num_samples, rank, len(collected))
        for i, r in zip(idx, results):
            merged[i] = r
    return merged


class SharedGenerator:
    """A ``torch.Generator`` that every rank seeds alike, and this rank's
    share of the global batch: ``rand`` draws the global batch's numbers
    (leading axis ``world`` times the local one) and keeps rows
    ``local_batch_slice``, so a step split over ranks draws the masks of
    the single-process step on the whole batch."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator = generator
        self.rank = rank
        self.world = world

    def rand(self, shape, device, dtype) -> torch.Tensor:
        b = shape[0]
        full = torch.rand((b * self.world, *shape[1:]),
                          generator=self.generator, device=device,
                          dtype=dtype)
        return full[local_batch_slice(b * self.world, self.rank, self.world)]


def batch_rand(shape, generator, device, dtype) -> torch.Tensor:
    """Uniform [0, 1) numbers of a batch's ``shape`` (leading axis the
    batch) from ``generator``: a ``torch.Generator`` (or None, the default
    one) or a ``SharedGenerator`` (this rank's rows of the global batch's
    draw)."""
    if isinstance(generator, SharedGenerator):
        return generator.rand(shape, device, dtype)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)
