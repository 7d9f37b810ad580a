"""Multi-process setup (counterpart of
``epn_pointcloud_tpu/parallel/distributed.py``).

The JAX package scales out as one SPMD program a host; the port runs one
process a GPU, wired together by ``torch.distributed``: NCCL between
cards, gloo on the CPU (and gloo where two ranks share one card, which
NCCL refuses). Every process loads its ``1/world`` slice of each global
batch (``process_slice``), the parameters are replicated, and the
collectives of ``parallel.mesh`` and ``parallel.collectives`` give the
global batch's numbers.

Launch with torchrun, which sets the rendezvous environment:

  python -m torch.distributed.run --nproc-per-node N \\
      -m epn_pointcloud_tpu_torch.run_modelnet experiment -d DIR ...

Without that environment ``init_distributed`` is a no-op returning 0 (one
process), so the trainers call these helpers unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# torchrun's rendezvous environment
ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def backend_for(device) -> str:
    """NCCL for a run on CUDA devices, gloo on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> int:
    """Join the process group; returns this process's rank.

    Explicit arguments initialize with them (``init_method`` defaults to
    ``env://``). With none: torchrun's environment (``ENV_KEYS``) is read
    when any of it is set, and then it must be whole; with none of it set
    this is a no-op returning 0. A group already initialized is kept. The
    backend defaults to NCCL when CUDA is available, else gloo. A failed
    rendezvous raises: there is no fallback to one process."""
    if dist.is_initialized():
        return dist.get_rank()
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not any(k in os.environ for k in ENV_KEYS):
        return 0
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if world_size is None:
        world_size = int(os.environ['WORLD_SIZE'])
    if rank is None:
        rank = int(os.environ['RANK'])
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group and uninstall the data group."""
    from .mesh import set_data_group
    set_data_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def process_env() -> tuple:
    """(world size, rank): (1, 0) without a process group. The one
    indirection the DataLoaders and tests read (monkeypatchable)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_slice(n: int) -> slice:
    """This process's contiguous shard of a length-n global batch axis."""
    pc, pi = process_env()
    assert n % pc == 0, (n, pc)
    per = n // pc
    return slice(pi * per, (pi + 1) * per)


def is_main() -> bool:
    """Rank 0: the one process that writes the run directory."""
    return process_env()[1] == 0


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def local_rank() -> int:
    """The rank among this host's processes (torchrun's LOCAL_RANK; 0)."""
    return int(os.environ.get('LOCAL_RANK', 0))


def device_for(device=None) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for None or a bare
    'cuda', else the device named (the CPU, or a CUDA device by index)."""
    if device is None or torch.device(device) == torch.device('cuda'):
        return torch.device('cuda', local_rank())
    return torch.device(device)
