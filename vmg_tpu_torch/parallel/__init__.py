"""Data, tensor and sequence parallelism over ``torch.distributed``
(``vmg_tpu/parallel``): the (data, tensor) process mesh and the sharded
train step (``mesh``), the tensor-sharded training state (``tp``), the
T-sharded serving forward (``seq``), the exchanges they make
(``exchange``) and the multi-process helpers (``multihost``)."""

from vmg_tpu_torch.parallel.mesh import (Mesh, average_across, make_mesh,
                                         make_sharded_train_step, process_local_batch_slice)
from vmg_tpu_torch.parallel.multihost import (all_gather_host_values, assert_same_across_hosts,
                                              broadcast_from_host0, initialize_distributed)
from vmg_tpu_torch.parallel.seq import make_seq_sharded_forward, shard_clip_over_time
from vmg_tpu_torch.parallel.tp import (gather_state, param_shardings, shard_params,
                                       shard_state, state_shardings)

__all__ = ["Mesh", "average_across", "make_mesh", "make_sharded_train_step",
           "process_local_batch_slice", "all_gather_host_values", "assert_same_across_hosts",
           "broadcast_from_host0", "initialize_distributed", "make_seq_sharded_forward",
           "shard_clip_over_time", "gather_state", "param_shardings", "shard_params",
           "shard_state", "state_shardings"]
