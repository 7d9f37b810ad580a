"""Hand-written Hopper kernels (counterpart of ``epn_pointcloud_tpu/ops/pallas``).

Each module holds one kernel's wrapper beside the plain PyTorch version of
the same function. A wrapper runs the plain version for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in a module-level integer ``launches``.

``plain()`` is the explicit switch the op layer reads to call the plain
versions directly on the card (to compare a whole forward against the kernel
path); the wrappers themselves never consult it.
"""

from __future__ import annotations

import contextlib

from . import ball_query, fps, inter_conv, intra_conv

KERNELS = (fps, ball_query, inter_conv, intra_conv)

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
        k.launches = 0


def counts() -> dict:
    return {k.NAME: k.launches for k in KERNELS}
