"""The data axis (counterpart of ``epn_pointcloud_tpu/parallel/mesh.py``).

The JAX package's mesh is a ('data', 'anchor') grid of devices: the batch
sharded over 'data', the parameters replicated, the gradient and batch
statistic collectives placed by XLA. The port's data axis is the process
group: one process a GPU, each on its slice of the global batch. The
collectives are explicit:

  * ``replicate``: the parameters and buffers broadcast from rank 0;
  * ``all_reduce_grads``: after ``backward()``, one flattened all-reduce of
    the gradients, divided by the world size (the SPMD step's gradient of
    the global batch's mean loss);
  * the BatchNorm statistics, the dropout masks and the triplet loss read
    the installed group (``set_data_group``) and give the global batch's
    numbers (``nn.layers``, ``app.trainer_3dmatch``).

No ``DistributedDataParallel``: the inv step runs two forwards of one
module before its one backward, which DDP's once-a-backward readiness
does not allow. The anchor axis (tensor parallelism over the 60 rotation
anchors) is not ported yet: ``make_mesh`` refuses ``n_anchor > 1``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .distributed import process_env

_DATA_GROUP = None


def make_mesh(n_data: Optional[int] = None, n_anchor: int = 1):
    """The data process group over every rank (None in one process without
    a group). ``n_anchor > 1`` (anchor-axis tensor parallelism) is refused
    until its slice is ported; ``n_data`` must be the world size."""
    if n_anchor < 1:
        raise ValueError(f'n_anchor={n_anchor} must be >= 1')
    if n_anchor > 1:
        raise NotImplementedError(
            f'--mesh-anchor {n_anchor}: anchor-axis tensor parallelism (the '
            f"JAX package's 'anchor' mesh axis) is not ported yet; it comes "
            f'with the anchor-parallel slice. Data parallelism runs one '
            f'process a GPU (torchrun)')
    world = process_env()[0]
    if n_data is not None and n_data != world:
        raise ValueError(f'n_data={n_data}: the data axis is every rank '
                         f'({world})')
    return dist.group.WORLD if dist.is_initialized() else None


def set_data_group(group) -> None:
    """Install the data group the norms, dropout and losses read (None:
    one process, today's local path)."""
    global _DATA_GROUP
    _DATA_GROUP = group


def data_group():
    return _DATA_GROUP


def data_world() -> int:
    """Ranks of the installed data group (1 without one)."""
    return 1 if _DATA_GROUP is None else dist.get_world_size(_DATA_GROUP)


def data_rank() -> int:
    return 0 if _DATA_GROUP is None else dist.get_rank(_DATA_GROUP)


def shard_batch(batch, device):
    """This process's slice of a batch (a dict, tuple or list of host
    arrays, as its loader gives it) as tensors on ``device``; other leaves
    (file names) as they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)) and batch and \
            isinstance(batch[0], np.ndarray):
        return type(batch)(shard_batch(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    return batch


def replicate(module: torch.nn.Module, group) -> None:
    """Broadcast ``module``'s parameters and buffers from rank 0 (no-op
    without a group)."""
    if group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=group)
            collectives.counts['broadcast'] += 1


def all_reduce_grads(module: torch.nn.Module, group) -> None:
    """Sum every parameter's ``.grad`` over the ranks in one flattened
    all-reduce, then divide by the world size (no-op without a group). The
    ranks' graphs are alike, so the same parameters carry a gradient on
    each."""
    if group is None:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives.all_reduce_(flat, group, 'grads')
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
