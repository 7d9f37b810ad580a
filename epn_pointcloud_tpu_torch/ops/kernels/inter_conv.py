"""Inter conv with the learned weight fused in: CUDA kernel wrapper and its
plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/inter_conv.py:fused_gather_conv_w``
(forward ``_call_gather_w`` / ``_call_gather_w_packed``):

  out[b, p, a, d] = sum_k sum_c F[b, p, a, k, c] W[k, c, d]
  F[b, p, a, k, c] = sum_n relu(1 - d2[b, p, n, a, k] / sigma)
                           * T[b, idx[b, p, n], a, c]
  d2 = (|gx|^2 + |kappa_k|^2) - 2 gx . (R_a kappa_k)

with T's shadow index (== q) reading a zero row. The plain version is the
anchor-chunked fp32 formulation of ``epn_pointcloud_tpu/ops/so3conv.py``
(``inter_so3conv_fused``, XLA path), so no [b, p, n, na, *] tensor for all
anchors exists at once.
"""

from __future__ import annotations

import torch

from . import build

NAME = 'inter_conv'
SOURCE = 'epn_pointcloud_tpu_torch/csrc/inter_conv.cu'
REPLACES = 'epn_pointcloud_tpu/ops/pallas/inter_conv.py:1010'
launches = 0

# anchors per step of the plain version: bounds its [b, p, n, chunk, *]
# intermediates (~1 GB at b=32 on the widest flagship layer)
ANCHOR_CHUNK = 10


def anchor_weights(gx: torch.Tensor, rk: torch.Tensor, k2: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """gx [b, p, n, 3], rk [a, k, 3], k2 [k] -> w [b, p, n, a, k]."""
    gx2 = (gx * gx).sum(-1)
    cross = torch.einsum('bpnc,akc->bpnak', gx, rk)
    d2 = (gx2[..., None, None] + k2) - 2.0 * cross
    return torch.relu(1.0 - d2 / sigma)


def inter_conv_plain(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                     rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """gx [b, p2, nn, 3], idx [b, p2, nn] in [0, q], table [b, q, na, c],
    rk [na, K, 3], k2 [K], W [K, c, d] -> out [b, p2, na, d]."""
    b, p2, nn = idx.shape
    na, c = table.shape[2], table.shape[3]
    K, d = W.shape[0], W.shape[2]
    table = torch.cat([table, table.new_zeros(b, 1, na, c)], dim=1)
    bi = torch.arange(b, device=idx.device)[:, None, None]
    idx = idx.long()
    W2 = W.reshape(K * c, d)
    outs = []
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)          # [b,p,n,ac,K]
        G = table[:, :, s:e][bi, idx]                        # [b,p,n,ac,c]
        F = torch.einsum('bpnak,bpnac->bpakc', w, G)
        outs.append((F.reshape(-1, K * c) @ W2).reshape(b, p2, e - s, d))
    return torch.cat(outs, dim=2)


def inter_conv(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
               rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    global launches
    if table.device.type == 'cpu':
        return inter_conv_plain(gx, idx, table, rk, k2, W, sigma)
    dev = table.device
    if dev.type != 'cuda':
        raise ValueError(f'inter_conv: unsupported device {dev}')
    b, q, na, c = table.shape
    _, p2, nn = idx.shape
    K, d = W.shape[0], W.shape[2]
    want = {'gx': (gx, torch.float32, (b, p2, nn, 3)),
            'idx': (idx, torch.int32, (b, p2, nn)),
            'table': (table, torch.float32, (b, q, na, c)),
            'rk': (rk, torch.float32, (na, K, 3)),
            'k2': (k2, torch.float32, (K,)),
            'W': (W, torch.float32, (K, c, d))}
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'inter_conv: {name} must be {dt} {shape} on '
                             f'{dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'inter_conv: {name} must be contiguous')
    if (c % 8 != 0 or K % 6 != 0 or d % 32 != 0 or nn < 1
            or b * p2 * na >= 2 ** 31):
        raise ValueError(f'inter_conv: kernel needs c % 8 == 0, K % 6 == 0, '
                         f'd % 32 == 0, nn >= 1 and b*p2*na < 2^31; got '
                         f'b={b} p2={p2} na={na} nn={nn} K={K} c={c} d={d}')
    out = torch.empty((b, p2, na, d), dtype=torch.float32, device=dev)
    launches += 1
    build.launch('epn_inter_conv', gx.data_ptr(), idx.data_ptr(),
                 table.data_ptr(), rk.data_ptr(), k2.data_ptr(), W.data_ptr(),
                 out.data_ptr(), b, p2, nn, q, na, K, c, d, float(sigma),
                 build.stream(table))
    return out
