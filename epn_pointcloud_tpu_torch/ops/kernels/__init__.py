"""Hand-written Hopper kernels (counterpart of ``epn_pointcloud_tpu/ops/pallas``).

Each module holds its kernels' wrappers beside the plain PyTorch versions of
the same functions, and lists them in ``ENTRIES`` (wrapper name -> plain
version, CUDA source, the TPU kernel it replaces). A wrapper runs the plain
version for a tensor on the CPU; for a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in its module's ``launches`` dict.
The conv modules also hold the ``torch.autograd.Function`` whose forward and
backward go through those wrappers.

``plain()`` is the explicit switch the op layer reads to call the plain
forward versions directly on the card (to compare a whole forward and
backward against the kernel path); the wrappers themselves never consult it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

from . import ball_query, fps, inter_conv, intra_conv


class Entry(NamedTuple):
    name: str        # wrapper function in `module`, and its launch-count key
    module: object
    plain: str       # the plain version in `module`
    source: str      # CUDA source
    replaces: str    # the TPU kernel (file:line)


KERNELS = tuple(Entry(name, m, *spec)
                for m in (fps, ball_query, inter_conv, intra_conv)
                for name, spec in m.ENTRIES.items())

_PLAIN = False


@contextlib.contextmanager
def plain():
    """Route the op layer to the plain PyTorch versions inside the block."""
    global _PLAIN
    old, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = old


def plain_forced() -> bool:
    return _PLAIN


def reset_counts() -> None:
    for k in KERNELS:
        k.module.launches[k.name] = 0


def counts() -> dict:
    return {k.name: k.module.launches[k.name] for k in KERNELS}
