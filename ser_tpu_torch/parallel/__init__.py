"""Data parallelism over ``torch.distributed`` (counterpart of
``ser_tpu/parallel``): ``mesh.py``; tensor parallelism over a (dp, tp)
grid of processes: ``tp.py``."""

from ser_tpu_torch.parallel.mesh import (all_reduce_grads, broadcast_params,
                                         gather_rows, initialize_distributed,
                                         local_batch_slice, world)
from ser_tpu_torch.parallel.tp import (Grid, gather_shards, local_shard, make_grid,
                                       param_spec, shard_dims, shard_model_,
                                       whole_parameters)

__all__ = ["Grid", "all_reduce_grads", "broadcast_params", "gather_rows", "gather_shards",
           "initialize_distributed", "local_batch_slice", "local_shard", "make_grid", "param_spec",
           "shard_dims", "shard_model_", "whole_parameters", "world"]
