"""Furthest point sampling: CUDA kernel wrapper and its plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/fps.py:fps_pallas``. Semantics: the
first sample is index 0; points with squared norm <= ``shadow_eps`` are never
picked; ties go to the lowest index (``argmax``). Distances are written as
``(dx*dx + dy*dy) + dz*dz`` in both versions, so the indices agree exactly.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/fps.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {'fps': ('fps_plain', SOURCE,
                   'epn_pointcloud_tpu/ops/pallas/fps.py:63')}
launches = dict.fromkeys(ENTRIES, 0)


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def fps_plain(xyz: torch.Tensor, n_sample: int,
              shadow_eps: float = 1e-3) -> torch.Tensor:
    """xyz [b, n, 3] f32 -> int32 idx [b, n_sample]."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = _sq3(x, y, z) > shadow_eps
    temp = torch.full((b, n), float('inf'), dtype=xyz.dtype,
                      device=xyz.device)
    neg_inf = torch.tensor(float('-inf'), dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((b, n_sample), dtype=torch.int64, device=xyz.device)
    old = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, n_sample):
        x1 = torch.gather(x, 1, old)
        y1 = torch.gather(y, 1, old)
        z1 = torch.gather(z, 1, old)
        d = _sq3(x - x1, y - y1, z - z1)
        temp = torch.minimum(temp, d)
        cand = torch.where(valid, temp, neg_inf)
        old = torch.argmax(cand, dim=1, keepdim=True)
        idxs[:, j] = old[:, 0]
    return idxs.to(torch.int32)


def fps(xyz: torch.Tensor, n_sample: int,
        shadow_eps: float = 1e-3) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if xyz.device.type == 'cpu':
        return fps_plain(xyz, n_sample, shadow_eps)
    if xyz.device.type != 'cuda':
        raise ValueError(f'fps: unsupported device {xyz.device}')
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f'fps: need f32 [b, n, 3], got {xyz.dtype} '
                         f'{tuple(xyz.shape)}')
    if not xyz.is_contiguous():
        raise ValueError('fps: xyz must be contiguous')
    b, n, _ = xyz.shape
    if not 0 < n_sample <= n or n > 12288:
        raise ValueError(f'fps: n_sample={n_sample}, n={n} unsupported')
    out = torch.empty((b, n_sample), dtype=torch.int32, device=xyz.device)
    launches['fps'] += 1
    build.launch('epn_fps', xyz.data_ptr(), out.data_ptr(), b, n, n_sample,
                 float(shadow_eps), build.stream(xyz))
    return out
