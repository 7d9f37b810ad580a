"""Intra (rotation-group) conv: CUDA kernel wrappers, their plain versions,
and the autograd Function that joins forward and backward.

Replaces ``epn_pointcloud_tpu/ops/pallas/intra_conv.py:intra_conv``
(forward ``_fwd_pallas`` -> ``_kernel``, VJP ``_intra_bwd`` -> ``_bwd_pallas``
-> ``_bwd_kernel``):

  out[b, p, a, d] = sum_k sum_c f[b, p, trace_idx[a, k], c] W[k, c, d]
  df[b, p, x, c] = sum_{(a, k): trace_idx[a, k] = x} sum_d dout[b, p, a, d]
                   W[k, c, d]
  dW[k, c, d] = sum_{b, p, a} f[b, p, trace_idx[a, k], c] dout[b, p, a, d]

Every column of trace_idx is a permutation of the anchors, so df is the
forward on (dout, inv_idx, W^T) with inv_idx the inverse adjacency
(``ops/icosahedron.get_intra_inv_idx``): on the card it runs the forward
kernel, and counts as one of its launches.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/intra_conv.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {
    'intra_conv': ('intra_conv_plain', SOURCE,
                   'epn_pointcloud_tpu/ops/pallas/intra_conv.py:98'),
    'intra_conv_dw': ('intra_conv_dw_plain', SOURCE,
                      'epn_pointcloud_tpu/ops/pallas/intra_conv.py:270'),
}
launches = dict.fromkeys(ENTRIES, 0)


def intra_conv_plain(f: torch.Tensor, trace_idx: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    """f [b, p, na, c], trace_idx [na, K] int, W [K, c, d] -> [b, p, na, d]."""
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    g = f[:, :, trace_idx.long()]                         # [b, p, na, K, c]
    return (g.reshape(-1, K * c) @ W.reshape(K * c, d)).reshape(b, p, na, d)


def intra_conv_df_plain(dout: torch.Tensor, trace_idx: torch.Tensor,
                        W: torch.Tensor) -> torch.Tensor:
    """df [b, p, na, c]: each (a, k) term dout[a] W[k]^T added onto input
    anchor trace_idx[a, k] (a scatter; no use of the inverse adjacency)."""
    b, p, na, _ = dout.shape
    K, c = W.shape[0], W.shape[1]
    g = torch.einsum('bpad,kcd->bpakc', dout, W).reshape(b, p, na * K, c)
    df = dout.new_zeros(b, p, na, c)
    return df.index_add(2, trace_idx.reshape(-1).long(), g)


def intra_conv_dw_plain(f: torch.Tensor, trace_idx: torch.Tensor,
                        dout: torch.Tensor) -> torch.Tensor:
    """dW [K, c, d] = sum over (b, p, a) of the gathered f^T dout."""
    g = f[:, :, trace_idx.long()]                         # [b, p, na, K, c]
    return torch.einsum('bpakc,bpad->kcd', g, dout)


def intra_conv(f: torch.Tensor, trace_idx: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """Forward kernel wrapper: plain version on the CPU, CUDA kernel on the
    card."""
    if f.device.type == 'cpu':
        return intra_conv_plain(f, trace_idx, W)
    dev = f.device
    if dev.type != 'cuda':
        raise ValueError(f'intra_conv: unsupported device {dev}')
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    build.check_operands('intra_conv', dev, {
        'f': (f, torch.float32, (b, p, na, c)),
        'trace_idx': (trace_idx, torch.int32, (na, K)),
        'W': (W, torch.float32, (K, c, d))})
    if c % 4 != 0 or d % 32 != 0 or na * K > 1024 or b * p * na >= 2 ** 31:
        raise ValueError(f'intra_conv: kernel needs c % 4 == 0, d % 32 == 0, '
                         f'na*K <= 1024 and b*p*na < 2^31; got b={b} p={p} '
                         f'na={na} K={K} c={c} d={d}')
    out = torch.empty((b, p, na, d), dtype=torch.float32, device=dev)
    launches['intra_conv'] += 1
    build.launch('epn_intra_conv', f.data_ptr(), trace_idx.data_ptr(),
                 W.data_ptr(), out.data_ptr(), b, p, na, K, c, d,
                 build.stream(f))
    return out


def intra_conv_df(dout: torch.Tensor, trace_idx: torch.Tensor,
                  inv_idx: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """df wrapper: the plain scatter on the CPU; on the card the forward
    kernel on (dout, inv_idx, W transposed to [K, d, c])."""
    if dout.device.type == 'cpu':
        return intra_conv_df_plain(dout, trace_idx, W)
    return intra_conv(dout, inv_idx, W.transpose(1, 2).contiguous())


def intra_conv_dw(f: torch.Tensor, trace_idx: torch.Tensor,
                  dout: torch.Tensor) -> torch.Tensor:
    """dW kernel wrapper: plain version on the CPU, CUDA kernel on the card
    (per-row-range partials summed in a fixed order: deterministic)."""
    if f.device.type == 'cpu':
        return intra_conv_dw_plain(f, trace_idx, dout)
    dev = f.device
    if dev.type != 'cuda':
        raise ValueError(f'intra_conv_dw: unsupported device {dev}')
    b, p, na, c = f.shape
    K, d = trace_idx.shape[1], dout.shape[-1]
    build.check_operands('intra_conv_dw', dev, {
        'f': (f, torch.float32, (b, p, na, c)),
        'trace_idx': (trace_idx, torch.int32, (na, K)),
        'dout': (dout, torch.float32, (b, p, na, d))})
    if c % 4 != 0 or d % 32 != 0 or na * K > 1024 or b * p * na >= 2 ** 31:
        raise ValueError(f'intra_conv_dw: kernel needs c % 4 == 0, '
                         f'd % 32 == 0, na*K <= 1024 and b*p*na < 2^31; got '
                         f'b={b} p={p} na={na} K={K} c={c} d={d}')
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    splits = build.n_splits(-(-K * c // 128) * (d // bn),
                            -(-b * p * na // 16))
    ws = torch.empty((splits, K, c, d), dtype=torch.float32, device=dev)
    dW = torch.empty((K, c, d), dtype=torch.float32, device=dev)
    launches['intra_conv_dw'] += 1
    build.launch('epn_intra_conv_bwd_w', f.data_ptr(), trace_idx.data_ptr(),
                 dout.data_ptr(), ws.data_ptr(), dW.data_ptr(), b, p, na, K, c,
                 d, splits, build.stream(f))
    return dW


class IntraConvFn(torch.autograd.Function):
    """The intra conv with its hand-written backward (the ``intra_conv``
    custom VJP): gradients to f and W."""

    @staticmethod
    def forward(ctx, f, trace_idx, inv_idx, W):
        ctx.save_for_backward(f, trace_idx, inv_idx, W)
        return intra_conv(f, trace_idx, W)

    @staticmethod
    def backward(ctx, dout):
        f, trace_idx, inv_idx, W = ctx.saved_tensors
        dout = dout.contiguous()
        df = dW = None
        if ctx.needs_input_grad[0]:
            df = intra_conv_df(dout, trace_idx, inv_idx, W)
        if ctx.needs_input_grad[3]:
            dW = intra_conv_dw(f, trace_idx, dout)
        return df, None, None, dW
