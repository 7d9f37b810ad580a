"""Data parallelism over ``torch.distributed`` (counterpart of
``epn_pointcloud_tpu/parallel``): the process setup (``distributed``), the
data group and its replication and gradient all-reduce (``mesh``), and
the collectives with autograd the global-batch BatchNorm statistics and
triplet loss ride on (``collectives``). ``dryrun`` runs one step of each
trainer at a world of N against one process."""

from .distributed import (  # noqa: F401
    backend_for, barrier, device_for, init_distributed, is_main,
    process_env, process_slice, shutdown)
from .mesh import (  # noqa: F401
    all_reduce_grads, data_group, data_rank, data_world, make_mesh,
    replicate, set_data_group, shard_batch)
