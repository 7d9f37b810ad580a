"""Ball query: CUDA kernel wrapper and its plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/ball_query.py:ball_query_pallas``
together with the repeat fill of ``epn_pointcloud_tpu/ops/sampling.py``
(``ball_query``, native convention). For each query, the first ``n_sample``
support indices in index order with direct-difference d^2 < r^2 (strict);
slot s >= cnt takes slot s % cnt, and a query with no hit gets all zeros.
Both versions compute d^2 as ``(dx*dx + dy*dy) + dz*dz`` in float32 and
compare against r^2 rounded to float32, so the indices agree exactly.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/ball_query.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {'ball_query': ('ball_query_plain', SOURCE,
                          'epn_pointcloud_tpu/ops/pallas/ball_query.py:57')}
launches = dict.fromkeys(ENTRIES, 0)


def _r2_f32(radius: float) -> float:
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def ball_query_plain(query: torch.Tensor, support: torch.Tensor,
                     radius: float, n_sample: int) -> torch.Tensor:
    """query [b, m, 3], support [b, n, 3] -> int32 idx [b, m, n_sample]."""
    b, m, _ = query.shape
    n = support.shape[1]
    k_eff = min(n_sample, n)
    diff = query[:, :, None, :] - support[:, None, :, :]       # [b, m, n, 3]
    dx, dy, dz = diff.unbind(-1)
    d2 = (dx * dx + dy * dy) + dz * dz
    hit = d2 < torch.tensor(_r2_f32(radius), dtype=d2.dtype, device=d2.device)
    # first k_eff hits in index order == the k_eff smallest keys of
    # key = index (hit) / n (miss)
    kidx = torch.arange(n, dtype=torch.int64, device=query.device)
    key = torch.where(hit, kidx, torch.full_like(kidx, n))
    first, _ = torch.topk(key, k_eff, dim=-1, largest=False, sorted=True)
    out = torch.where(first < n, first, torch.zeros_like(first))
    if k_eff < n_sample:
        out = torch.nn.functional.pad(out, (0, n_sample - k_eff))
    cnt = hit.sum(-1).clamp(max=n_sample)                      # [b, m]
    s = torch.arange(n_sample, device=query.device)[None, None, :]
    src = torch.where(s < cnt[..., None], s,
                      s % cnt.clamp(min=1)[..., None])
    return torch.gather(out, 2, src).to(torch.int32)


def ball_query(query: torch.Tensor, support: torch.Tensor, radius: float,
               n_sample: int) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if query.device.type == 'cpu':
        return ball_query_plain(query, support, radius, n_sample)
    if query.device.type != 'cuda' or support.device != query.device:
        raise ValueError(f'ball_query: unsupported devices {query.device}, '
                         f'{support.device}')
    for name, t in (('query', query), ('support', support)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3:
            raise ValueError(f'ball_query: {name} must be f32 [b, *, 3], got '
                             f'{t.dtype} {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'ball_query: {name} must be contiguous')
    b, m, _ = query.shape
    if support.shape[0] != b:
        raise ValueError('ball_query: batch mismatch')
    n = support.shape[1]
    if n_sample < 1:
        raise ValueError(f'ball_query: n_sample={n_sample}')
    out = torch.empty((b, m, n_sample), dtype=torch.int32, device=query.device)
    launches['ball_query'] += 1
    build.launch('epn_ball_query', query.data_ptr(), support.data_ptr(),
                 out.data_ptr(), b, m, n, n_sample, _r2_f32(radius),
                 build.stream(query))
    return out
