"""Inter conv with the learned weight fused in: CUDA kernel wrappers, their
plain versions, and the autograd Function that joins forward and backward.

Replaces ``epn_pointcloud_tpu/ops/pallas/inter_conv.py:fused_gather_conv_w``
(forward ``_call_gather_w`` / ``_call_gather_w_packed``, VJP ``_fgcw_bwd`` ->
``_call_gather_w_bwd`` / ``_call_gather_w_bwd_split``):

  out[b, p, a, d] = sum_k sum_c F[b, p, a, k, c] W[k, c, d]
  F[b, p, a, k, c] = sum_n relu(1 - d2[b, p, n, a, k] / sigma)
                           * T[b, idx[b, p, n], a, c]
  d2 = (|gx|^2 + |kappa_k|^2) - 2 gx . (R_a kappa_k)

with T's shadow index (== q) reading a zero row, and its gradients

  dT[b, idx[b, p, n], a, c] += sum_k w[b, p, n, a, k] dF[b, p, a, k, c]
  dF[b, p, a, k, c] = sum_d dout[b, p, a, d] W[k, c, d]
  dW[k, c, d] = sum_{b, p, a} F[b, p, a, k, c] dout[b, p, a, d].

The plain versions are anchor-chunked fp32 formulations (the forward that of
``epn_pointcloud_tpu/ops/so3conv.py`` ``inter_so3conv_fused``, XLA path), so
no [b, p, n, na, *] tensor for all anchors exists at once.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/inter_conv.cu'
BWD_SOURCE = 'epn_pointcloud_tpu_torch/csrc/inter_conv_bwd.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {
    'inter_conv': ('inter_conv_plain', SOURCE,
                   'epn_pointcloud_tpu/ops/pallas/inter_conv.py:1010'),
    'inter_conv_dtable': ('inter_conv_dtable_plain', BWD_SOURCE,
                          'epn_pointcloud_tpu/ops/pallas/inter_conv.py:1070'),
    'inter_conv_dw': ('inter_conv_dw_plain', BWD_SOURCE,
                      'epn_pointcloud_tpu/ops/pallas/inter_conv.py:1272'),
}
launches = dict.fromkeys(ENTRIES, 0)

# anchors per step of the plain versions: bounds their [b, p, n, chunk, *]
# intermediates (~1 GB at b=32 on the widest flagship layer)
ANCHOR_CHUNK = 10
# the backward kernels are written for the model's 24 kernel points
N_KERNEL = 24


def anchor_weights(gx: torch.Tensor, rk: torch.Tensor, k2: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """gx [b, p, n, 3], rk [a, k, 3], k2 [k] -> w [b, p, n, a, k]."""
    gx2 = (gx * gx).sum(-1)
    cross = torch.einsum('bpnc,akc->bpnak', gx, rk)
    d2 = (gx2[..., None, None] + k2) - 2.0 * cross
    return torch.relu(1.0 - d2 / sigma)


def _gather_chunk(table: torch.Tensor, idx: torch.Tensor, s: int, e: int):
    """Rows T[b, idx[b, p, n], s:e] of the shadow-padded table [b, q+1, ...]
    -> [b, p, n, e - s, c]."""
    bi = torch.arange(table.shape[0], device=idx.device)[:, None, None]
    return table[:, :, s:e][bi, idx]


def inter_conv_plain(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                     rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """gx [b, p2, nn, 3], idx [b, p2, nn] in [0, q], table [b, q, na, c],
    rk [na, K, 3], k2 [K], W [K, c, d] -> out [b, p2, na, d]."""
    b, p2, nn = idx.shape
    na, c = table.shape[2], table.shape[3]
    K, d = W.shape[0], W.shape[2]
    table = torch.cat([table, table.new_zeros(b, 1, na, c)], dim=1)
    idx = idx.long()
    W2 = W.reshape(K * c, d)
    outs = []
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)          # [b,p,n,ac,K]
        G = _gather_chunk(table, idx, s, e)                  # [b,p,n,ac,c]
        F = torch.einsum('bpnak,bpnac->bpakc', w, G)
        outs.append((F.reshape(-1, K * c) @ W2).reshape(b, p2, e - s, d))
    return torch.cat(outs, dim=2)


def inter_conv_dtable_plain(gx: torch.Tensor, idx: torch.Tensor, q: int,
                            rk: torch.Tensor, k2: torch.Tensor,
                            W: torch.Tensor, dout: torch.Tensor,
                            sigma: float) -> torch.Tensor:
    """dT [b, q, na, c] from dout [b, p2, na, d]: each neighbor slot's
    sum_k w dF scattered onto its table row (the shadow row dropped)."""
    b, p2, nn = idx.shape
    na, c = rk.shape[0], W.shape[1]
    # flat row of (b, idx) in the shadow-padded [b * (q + 1)] table
    rows = (idx.long() + (q + 1) * torch.arange(
        b, device=idx.device)[:, None, None]).reshape(-1)
    dT = dout.new_zeros(b * (q + 1), na, c)
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)          # [b,p,n,ac,K]
        dF = torch.einsum('bpad,kcd->bpakc', dout[:, :, s:e], W)
        g = torch.einsum('bpnak,bpakc->bpnac', w, dF)
        dT[:, s:e] = dT[:, s:e].index_add(0, rows, g.reshape(-1, e - s, c))
    return dT.reshape(b, q + 1, na, c)[:, :q]


def inter_conv_dw_plain(gx: torch.Tensor, idx: torch.Tensor,
                        table: torch.Tensor, rk: torch.Tensor,
                        k2: torch.Tensor, dout: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """dW [K, c, d] = sum over (b, p, a) of F^T dout."""
    b, _, _ = idx.shape
    na, c = table.shape[2], table.shape[3]
    table = torch.cat([table, table.new_zeros(b, 1, na, c)], dim=1)
    idx = idx.long()
    dW = dout.new_zeros(rk.shape[1], c, dout.shape[-1])
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)
        G = _gather_chunk(table, idx, s, e)
        F = torch.einsum('bpnak,bpnac->bpakc', w, G)
        dW += torch.einsum('bpakc,bpad->kcd', F, dout[:, :, s:e])
    return dW


def _check(kernel, gx, idx, table_shape, rk, k2, W_shape, dout=None,
           table=None, W=None):
    """Device, dtype, shape, contiguity and kernel-shape checks shared by the
    three wrappers; returns (b, p2, nn, q, na, K, c, d)."""
    dev = gx.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, q, na, c = table_shape
    _, p2, nn = idx.shape
    K, d = W_shape[0], W_shape[2]
    want = {'gx': (gx, torch.float32, (b, p2, nn, 3)),
            'idx': (idx, torch.int32, (b, p2, nn)),
            'rk': (rk, torch.float32, (na, K, 3)),
            'k2': (k2, torch.float32, (K,))}
    if table is not None:
        want['table'] = (table, torch.float32, (b, q, na, c))
    if W is not None:
        want['W'] = (W, torch.float32, (K, c, d))
    if dout is not None:
        want['dout'] = (dout, torch.float32, (b, p2, na, d))
    build.check_operands(kernel, dev, want)
    if (c % 8 != 0 or K % 6 != 0 or d % 32 != 0 or nn < 1
            or b * p2 * na >= 2 ** 31):
        raise ValueError(f'{kernel}: kernel needs c % 8 == 0, K % 6 == 0, '
                         f'd % 32 == 0, nn >= 1 and b*p2*na < 2^31; got '
                         f'b={b} p2={p2} na={na} nn={nn} K={K} c={c} d={d}')
    return b, p2, nn, q, na, K, c, d


def inter_conv(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
               rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """Forward kernel wrapper: plain version on the CPU, CUDA kernel on the
    card."""
    if table.device.type == 'cpu':
        return inter_conv_plain(gx, idx, table, rk, k2, W, sigma)
    b, p2, nn, q, na, K, c, d = _check('inter_conv', gx, idx, table.shape, rk,
                                       k2, W.shape, table=table, W=W)
    out = torch.empty((b, p2, na, d), dtype=torch.float32, device=gx.device)
    launches['inter_conv'] += 1
    build.launch('epn_inter_conv', gx.data_ptr(), idx.data_ptr(),
                 table.data_ptr(), rk.data_ptr(), k2.data_ptr(), W.data_ptr(),
                 out.data_ptr(), b, p2, nn, q, na, K, c, d, float(sigma),
                 build.stream(table))
    return out


def inter_conv_dtable(gx: torch.Tensor, idx: torch.Tensor, q: int,
                      rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
                      dout: torch.Tensor, sigma: float) -> torch.Tensor:
    """dTable kernel wrapper: plain version on the CPU, CUDA kernel on the
    card. Its atomics make dT's last-bit rounding vary between runs."""
    if dout.device.type == 'cpu':
        return inter_conv_dtable_plain(gx, idx, q, rk, k2, W, dout, sigma)
    shape = (idx.shape[0], q, rk.shape[0], W.shape[1])
    b, p2, nn, q, na, K, c, d = _check('inter_conv_dtable', gx, idx, shape,
                                       rk, k2, W.shape, dout=dout, W=W)
    if K != N_KERNEL:
        raise ValueError(f'inter_conv_dtable: kernel needs K == {N_KERNEL}; '
                         f'got K={K}')
    dT = torch.zeros(shape, dtype=torch.float32, device=dout.device)
    launches['inter_conv_dtable'] += 1
    build.launch('epn_inter_conv_bwd_table', gx.data_ptr(), idx.data_ptr(),
                 rk.data_ptr(), k2.data_ptr(), W.data_ptr(), dout.data_ptr(),
                 dT.data_ptr(), b, p2, nn, q, na, K, c, d, float(sigma),
                 build.stream(dout))
    return dT


def inter_conv_dw(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                  rk: torch.Tensor, k2: torch.Tensor, dout: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """dW kernel wrapper: plain version on the CPU, CUDA kernel on the card
    (per-row-range partials summed in a fixed order: deterministic)."""
    if dout.device.type == 'cpu':
        return inter_conv_dw_plain(gx, idx, table, rk, k2, dout, sigma)
    W_shape = (rk.shape[1], table.shape[3], dout.shape[-1])
    b, p2, nn, q, na, K, c, d = _check('inter_conv_dw', gx, idx, table.shape,
                                       rk, k2, W_shape, dout=dout, table=table)
    if K != N_KERNEL or d % 64 != 0:
        raise ValueError(f'inter_conv_dw: kernel needs K == {N_KERNEL} and '
                         f'd % 64 == 0; got K={K} d={d}')
    bn = 128 if d % 128 == 0 else 64
    splits = build.n_splits((d // bn) * (c // 8), -(-b * p2 * na // 64))
    dev = dout.device
    ws = torch.empty((splits, K, c, d), dtype=torch.float32, device=dev)
    dW = torch.empty((K, c, d), dtype=torch.float32, device=dev)
    launches['inter_conv_dw'] += 1
    build.launch('epn_inter_conv_bwd_w', gx.data_ptr(), idx.data_ptr(),
                 table.data_ptr(), rk.data_ptr(), k2.data_ptr(),
                 dout.data_ptr(), ws.data_ptr(), dW.data_ptr(), b, p2, nn, q,
                 na, K, c, d, float(sigma), splits, build.stream(dout))
    return dW


class InterConvFn(torch.autograd.Function):
    """The W-fused inter conv with its hand-written backward (the
    ``fused_gather_conv_w`` custom VJP). Gradients flow to the table and W
    only: gx, idx, rk, k2 and sigma get none, as the JAX VJP zeroes them."""

    @staticmethod
    def forward(ctx, gx, idx, table, rk, k2, W, sigma):
        ctx.save_for_backward(gx, idx, table, rk, k2, W)
        ctx.sigma = sigma
        return inter_conv(gx, idx, table, rk, k2, W, sigma)

    @staticmethod
    def backward(ctx, dout):
        gx, idx, table, rk, k2, W = ctx.saved_tensors
        dout = dout.contiguous()
        dT = dW = None
        if ctx.needs_input_grad[2]:
            dT = inter_conv_dtable(gx, idx, table.shape[1], rk, k2, W, dout,
                                   ctx.sigma)
        if ctx.needs_input_grad[5]:
            dW = inter_conv_dw(gx, idx, table, rk, k2, dout, ctx.sigma)
        return None, None, dT, None, None, dW, None
