"""Data and tensor parallelism over ``torch.distributed``: process-group
start-up and gathers (``distributed``), the device mesh and the batch's
placement (``mesh``), and the decoder's tensor-parallel split (``tp``)."""

from molnextr_tpu_torch.parallel.distributed import (
    barrier,
    gather_arrays,
    initialize,
    is_main_process,
    process_count,
    process_index,
)
from molnextr_tpu_torch.parallel.mesh import (
    data_sharding,
    local_batch_size,
    make_mesh,
    pad_to_devices,
    replicated,
    shard_batch,
    shard_batch_group,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "shard_batch_group",
    "local_batch_size",
    "pad_to_devices",
    "initialize",
    "process_count",
    "process_index",
    "is_main_process",
    "gather_arrays",
    "barrier",
]
