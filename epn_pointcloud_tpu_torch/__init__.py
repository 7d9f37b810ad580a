"""PyTorch + CUDA port of epn_pointcloud_tpu for NVIDIA Hopper (H100).

It holds the fp32 ModelNet40 path of ``cls_so3net_pn``, inference and
training: the numpy geometry statics, the sampling and SO(3) conv ops, the
layers, blocks, head and model, the losses, Adam with its schedule
(``train``), the train and eval entry point, and hand-written CUDA kernels
(``csrc/``: furthest point sampling, ball query, the W-fused inter conv
forward and its dTable / dW backward, the intra conv forward and its dW
backward), each with a plain PyTorch version beside it (``ops/kernels``).
The package imports torch and never jax.
"""

from . import models, nn, ops  # noqa: F401
