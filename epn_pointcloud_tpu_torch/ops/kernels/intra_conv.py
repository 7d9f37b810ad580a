"""Intra (rotation-group) conv: CUDA kernel wrapper and its plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/intra_conv.py:intra_conv``
(forward ``_fwd_pallas`` -> ``_kernel``):

  out[b, p, a, d] = sum_k sum_c f[b, p, trace_idx[a, k], c] W[k, c, d]
"""

from __future__ import annotations

import torch

from . import build

NAME = 'intra_conv'
SOURCE = 'epn_pointcloud_tpu_torch/csrc/intra_conv.cu'
REPLACES = 'epn_pointcloud_tpu/ops/pallas/intra_conv.py:98'
launches = 0


def intra_conv_plain(f: torch.Tensor, trace_idx: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    """f [b, p, na, c], trace_idx [na, K] int, W [K, c, d] -> [b, p, na, d]."""
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    g = f[:, :, trace_idx.long()]                         # [b, p, na, K, c]
    return (g.reshape(-1, K * c) @ W.reshape(K * c, d)).reshape(b, p, na, d)


def intra_conv(f: torch.Tensor, trace_idx: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    global launches
    if f.device.type == 'cpu':
        return intra_conv_plain(f, trace_idx, W)
    dev = f.device
    if dev.type != 'cuda':
        raise ValueError(f'intra_conv: unsupported device {dev}')
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    want = {'f': (f, torch.float32, (b, p, na, c)),
            'trace_idx': (trace_idx, torch.int32, (na, K)),
            'W': (W, torch.float32, (K, c, d))}
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'intra_conv: {name} must be {dt} {shape} on '
                             f'{dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'intra_conv: {name} must be contiguous')
    if c % 4 != 0 or d % 32 != 0 or na * K > 1024 or b * p * na >= 2 ** 31:
        raise ValueError(f'intra_conv: kernel needs c % 4 == 0, d % 32 == 0, '
                         f'na*K <= 1024 and b*p*na < 2^31; got b={b} p={p} '
                         f'na={na} K={K} c={c} d={d}')
    out = torch.empty((b, p, na, d), dtype=torch.float32, device=dev)
    launches += 1
    build.launch('epn_intra_conv', f.data_ptr(), trace_idx.data_ptr(),
                 W.data_ptr(), out.data_ptr(), b, p, na, K, c, d,
                 build.stream(f))
    return out
