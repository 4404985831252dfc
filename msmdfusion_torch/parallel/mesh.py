"""Data parallelism over the process group: replicated parameters,
batch-sharded inputs.

Counterpart of the JAX package's ``parallel/mesh.py`` (reference
``MMDistributedDataParallel``): ``replicate`` makes every rank hold rank
0's parameters and buffers, ``shard_batch`` cuts this rank's contiguous
slice out of a global batch. The gradients' reduction is the train step's
(``apis/train.py``), the batch norms' global moments ``models/layers.py``'s.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .distributed import (broadcast_tensors, get_rank, get_world_size,
                          local_batch_slice)


@torch.no_grad()
def replicate(model: nn.Module, src: int = 0) -> nn.Module:
    """Every parameter and buffer of ``model`` set to rank ``src``'s, in
    place (a no-op without a group)."""
    broadcast_tensors(list(model.parameters()) + list(model.buffers()), src)
    return model


def shard_batch(batch: Any, rank: int = None, world: int = None) -> Any:
    """This rank's contiguous slice of every tensor's leading (batch) axis
    in ``batch`` (nested dicts, lists and tuples walked; other leaves kept);
    ``rank``/``world`` default to the group's."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world

    def cut(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            return x[local_batch_slice(x.shape[0], rank, world)]
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        return x
    return cut(batch)
