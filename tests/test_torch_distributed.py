"""The port's process-group helpers (``msmdfusion_torch.parallel``) vs the
JAX package's ``parallel/distributed.py``, and over 4 gloo ranks on the
CPU.

- ``shard_indices``, ``local_batch_slice`` and ``merge_sharded_results``
  equal the JAX functions (explicit rank and world where the JAX function
  reads the process index: there, one process).
- ``collect_results`` over 4 ranks (both launchers' environments) gives
  every rank each rank's results in rank order; merged, dataset order.
- ``replicate`` gives every rank rank 0's parameters and buffers;
  ``shard_batch`` cuts the rank's rows of every tensor.
- ``init_dist('none')`` joins nothing; an unknown launcher raises, naming
  the three; ``pytorch`` and ``manual`` without their environment raise.
"""
import numpy as np
import pytest
import torch

from msmdfusion_tpu.parallel import distributed as jdist

from msmdfusion_torch.parallel import (grouped, init_dist, local_batch_slice,
                                       merge_sharded_results, shard_indices)
from tests.torch_ranks import collect_rank, run_ranks


@pytest.mark.parametrize('n,world', [(10, 4), (7, 3), (5, 1), (2, 4)])
def test_shards_equal_jax(n, world):
    for rank in range(world):
        np.testing.assert_array_equal(
            shard_indices(n, rank, world),
            jdist.shard_indices(n, rank=rank, world=world))
    collected = [(r, [f'{i}' for i in shard_indices(n, r, world)])
                 for r in range(world)]
    assert merge_sharded_results(collected, n) == \
        jdist.merge_sharded_results(collected, n) == [f'{i}' for i in
                                                      range(n)]
    assert local_batch_slice(12, 0, 1) == jdist.local_batch_slice(12)
    assert [local_batch_slice(8, r, 4) for r in range(4)] == [
        slice(2 * r, 2 * r + 2) for r in range(4)]
    with pytest.raises(ValueError, match='does not split'):
        local_batch_slice(6, 0, 4)


@pytest.mark.parametrize('launcher', ['manual', 'pytorch'])
def test_collect_results_over_four_ranks(launcher):
    n, world = 10, 4
    out = run_ranks(collect_rank, world, n, launcher=launcher)
    want = [(r, [f'sample {i}' for i in shard_indices(n, r, world)])
            for r in range(world)]
    for rank, res in enumerate(out):
        assert res['collected'] == want
        assert res['merged'] == [f'sample {i}' for i in range(n)]
        np.testing.assert_array_equal(res['weight'], out[0]['weight'])
        np.testing.assert_array_equal(res['stat'], np.zeros(2))
        shard = res['shard']
        assert torch.equal(shard['x'], torch.arange(world * 6).reshape(
            world * 2, 3)[2 * rank:2 * rank + 2])
        assert torch.equal(shard['nested'][0],
                           torch.arange(2 * rank, 2 * rank + 2))
        assert shard['meta'] == 'kept'
    torch.manual_seed(1)           # rank 1's draw differs from rank 0's
    assert not np.array_equal(torch.nn.Linear(3, 2).weight.detach().numpy(),
                              out[0]['weight'])


def test_launchers(monkeypatch):
    assert init_dist('none', 'cpu') == torch.device('cpu')
    assert not grouped()
    with pytest.raises(ValueError, match='none, pytorch, manual'):
        init_dist('slurm', 'cpu')
    for var in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MSMD_COORDINATOR',
                'MSMD_NUM_PROCESSES', 'MSMD_PROCESS_ID'):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match='RANK, WORLD_SIZE, LOCAL_RANK'):
        init_dist('pytorch', 'cpu')
    with pytest.raises(RuntimeError, match='MSMD_COORDINATOR'):
        init_dist('manual', 'cpu')
    assert not grouped()
