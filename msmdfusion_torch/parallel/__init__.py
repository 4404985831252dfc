"""Data-parallel training and rank-sharded evaluation over a
``torch.distributed`` process group (counterpart of the JAX package's
``parallel``)."""
from .distributed import (LAUNCHERS, SharedGenerator, all_sum,  # noqa: F401
                          collect_results, dist_scope, get_rank,
                          get_world_size, grouped, init_dist,
                          local_batch_slice, merge_sharded_results,
                          shard_indices)
from .mesh import replicate, shard_batch  # noqa: F401
