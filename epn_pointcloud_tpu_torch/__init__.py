"""PyTorch + CUDA port of epn_pointcloud_tpu for NVIDIA Hopper (H100).

The first slice is the fp32 ModelNet40 inference path of ``cls_so3net_pn``:
the numpy geometry statics, the sampling and SO(3) conv ops, the layers,
blocks, head and model, the eval entry point, and four hand-written CUDA
kernels (``csrc/``: furthest point sampling, ball query, the W-fused inter
conv and the intra conv), each with a plain PyTorch version beside it
(``ops/kernels``). The package imports torch and never jax.
"""

from . import models, nn, ops  # noqa: F401
