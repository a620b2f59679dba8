"""Data parallelism over ``torch.distributed`` (counterpart of
``ser_tpu/parallel``): ``mesh.py``."""

from ser_tpu_torch.parallel.mesh import (all_reduce_grads, broadcast_params,
                                         gather_rows, initialize_distributed,
                                         local_batch_slice, world)

__all__ = ["all_reduce_grads", "broadcast_params", "gather_rows",
           "initialize_distributed", "local_batch_slice", "world"]
