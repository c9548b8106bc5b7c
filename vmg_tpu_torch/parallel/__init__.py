"""Data parallelism over ``torch.distributed`` (``vmg_tpu/parallel``'s
``mesh`` and ``multihost``).  Tensor and sequence parallelism (``tp.py``,
``seq.py``) are not ported: a ``tensor`` axis above 1 is refused."""

from vmg_tpu_torch.parallel.mesh import (Mesh, average_across, make_mesh,
                                         make_sharded_train_step, process_local_batch_slice)
from vmg_tpu_torch.parallel.multihost import (all_gather_host_values, assert_same_across_hosts,
                                              broadcast_from_host0, initialize_distributed)

__all__ = ["Mesh", "average_across", "make_mesh", "make_sharded_train_step",
           "process_local_batch_slice", "all_gather_host_values", "assert_same_across_hosts",
           "broadcast_from_host0", "initialize_distributed"]
