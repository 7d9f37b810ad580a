"""Block-0 inter conv on the occupancy-ones input: the CUDA kernel wrapper and
its plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/ones_conv.py:ones_weight_sum``
(``_ones_fwd`` -> ``_kernel``):

  F[b, p, a, k] = sum_n relu(1 - |gx[b, p, n] - R_a kappa_k|^2 / sigma)

over the layer-0 ball-query neighbors (every gathered feature is 1, so the
neighbor contraction is the anchor-weight sum). Coordinates and sums are
fp32; F is written in the compute dtype. F depends on the coordinates only,
so no gradient flows through it (the TPU kernel's VJP is zero): the learned
[K, d] product that follows runs under autograd outside.

The kernel (``ones_conv_kernel`` in csrc/ones_conv.cu) folds each weight
to (1 - |kappa_k|^2 / sigma - |gx|^2 / sigma) + gx . (2 R_a kappa_k / sigma)
clamped to [0, 1], and sums each lane's neighbors in four interleaved
partial sums, so its F rounds otherwise than the plain version's: both
are fp32.
"""

from __future__ import annotations

import torch

from . import build
from .inter_conv import ANCHOR_CHUNK, anchor_weights

SOURCE = 'epn_pointcloud_tpu_torch/csrc/ones_conv.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {
    'ones_conv': ('ones_conv_plain', SOURCE,
                  'epn_pointcloud_tpu/ops/pallas/ones_conv.py:247'),
}
launches = dict.fromkeys(ENTRIES, 0)
# the kernel stages at least one point's neighbors (16 bytes each) in 227 KB
# of shared memory, and a block's threads are a multiple of K, at most 512
MAX_NN = 227 * 1024 // 16
MAX_K = 512


def ones_conv_plain(gx: torch.Tensor, rk: torch.Tensor, k2: torch.Tensor,
                    sigma: float, dtype=torch.float32) -> torch.Tensor:
    """gx [b, p2, nn, 3], rk [na, K, 3], k2 [K] -> F [b, p2, na, K] in
    ``dtype`` (anchor-chunked: no [b, p2, nn, na, K] tensor for all anchors
    at once)."""
    na = rk.shape[0]
    F = torch.cat([anchor_weights(gx, rk[s:s + ANCHOR_CHUNK], k2,
                                  sigma).sum(dim=2)
                   for s in range(0, na, ANCHOR_CHUNK)], dim=2)
    return F.to(dtype)


def ones_conv(gx: torch.Tensor, rk: torch.Tensor, k2: torch.Tensor,
              sigma: float, dtype=torch.float32) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if gx.device.type == 'cpu':
        return ones_conv_plain(gx, rk, k2, sigma, dtype)
    dev = gx.device
    if dev.type != 'cuda':
        raise ValueError(f'ones_conv: unsupported device {dev}')
    b, p2, nn, _ = gx.shape
    na, K = rk.shape[0], rk.shape[1]
    build.check_operands('ones_conv', dev, {
        'gx': (gx, torch.float32, (b, p2, nn, 3)),
        'rk': (rk, torch.float32, (na, K, 3)),
        'k2': (k2, torch.float32, (K,))})
    if not (1 <= nn <= MAX_NN and 1 <= K <= MAX_K and na >= 1
            and b * p2 * na * K < 2 ** 31):
        raise ValueError(f'ones_conv: kernel needs 1 <= nn <= {MAX_NN}, '
                         f'1 <= K <= {MAX_K} and b*p2*na*K < 2^31; got b={b} '
                         f'p2={p2} nn={nn} na={na} K={K}')
    bf16 = build.dtype_flag(dtype, 'ones_conv')
    out = torch.empty((b, p2, na, K), dtype=dtype, device=dev)
    launches['ones_conv'] += 1
    build.launch('epn_ones_conv', gx.data_ptr(), rk.data_ptr(), k2.data_ptr(),
                 out.data_ptr(), b, p2, nn, na, K, float(sigma), bf16,
                 build.stream(gx))
    return out
