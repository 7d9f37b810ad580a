"""PyTorch + CUDA port of epn_pointcloud_tpu for NVIDIA Hopper (H100).

It holds the three models of the JAX package, inference and training, in
fp32 and the bf16 production mode: ModelNet40 classification
(``cls_so3net_pn``, ``run_modelnet``), 3DMatch descriptors and their
evaluation (``inv_so3net_pn``, ``run_3dmatch``) and relative-rotation
regression (``reg_so3net``, ``run_modelnet_rotation``); the numpy geometry
statics, the sampling and SO(3) conv ops, the layers, blocks, heads and
models, the losses, Adam with its schedule (``train``), the data loaders,
the 3DMatch recall (``eval``), and hand-written CUDA kernels (``csrc/``),
each with a plain PyTorch version beside it (``ops/kernels``). The package
imports torch and never jax.
"""

from . import models, nn, ops  # noqa: F401
