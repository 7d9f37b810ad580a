"""Grouped (per-anchor) 1x1 conv and the fused separable-block tail: the CUDA
kernel wrappers and their plain versions.

Replaces ``epn_pointcloud_tpu/ops/pallas/grouped_conv.py``:
``grouped_conv1x1`` (``_fwd`` -> ``_fwd_kernel``) and
``grouped_conv1x1_skip_epilogue`` (``_fwd_skip_kernel``):

  grouped_conv:       out[b, p, a, :] = x[b, p, a, :] @ W + bias
  grouped_conv_tail:  out = act(y * ssm0 + ssm1)
                            + act((x @ W + bias) * ssk0 + ssk1)

with one [c, d] weight for every anchor. In the tail, ``y`` is the raw
intra conv output and ``ssm`` its InstanceNorm folded to per-lane
scale/shift (rows 0 and 1 of [b, 2, na*d]), ``ssk`` the eval BatchNorm of
the skip branch folded the same way ([1, 2, na*d], broadcast over the
batch), act the leaky ReLU with mask ``u > 0``. Both compute in fp32 from
fp32 or bf16 operands and round once to the operand type; bias and the
folds are fp32. The plain conv has a backward, replacing ``_gc_bwd`` ->
``_bwd_kernel`` (``GroupedConvFn``):

  dx = dout @ W^T,  dW = x^T dout (over every (point, anchor) row),
  dbias = sum of dout over the rows (a plain reduce, as in the JAX package);

the fused tail is inference only.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/grouped_conv.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {
    'grouped_conv': ('grouped_conv_plain', SOURCE,
                     'epn_pointcloud_tpu/ops/pallas/grouped_conv.py:212'),
    'grouped_conv_tail': ('grouped_conv_tail_plain', SOURCE,
                          'epn_pointcloud_tpu/ops/pallas/grouped_conv.py:132'),
    'grouped_conv_dx': ('grouped_conv_dx_plain', SOURCE,
                        'epn_pointcloud_tpu/ops/pallas/grouped_conv.py:66'),
    'grouped_conv_dw': ('grouped_conv_dw_plain', SOURCE,
                        'epn_pointcloud_tpu/ops/pallas/grouped_conv.py:66'),
}
launches = dict.fromkeys(ENTRIES, 0)


def _conv_f32(x, W, bias):
    """x [b, p, na, c] @ W [c, d] + bias, widened -> [b, p, na * d]."""
    b, p, na, c = x.shape
    y = build.widen(x).reshape(-1, c) @ build.widen(W) + bias
    return y.reshape(b, p, na * W.shape[1])


def grouped_conv_plain(x: torch.Tensor, W: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """x [b, p, na, c], W [c, d], bias [d] fp32 -> [b, p, na, d] (x's
    type)."""
    b, p, na, _ = x.shape
    return _conv_f32(x, W, bias).to(x.dtype).reshape(b, p, na, -1)


def grouped_conv_tail_plain(x: torch.Tensor, W: torch.Tensor,
                            bias: torch.Tensor, ssk: torch.Tensor,
                            y: torch.Tensor, ssm: torch.Tensor) -> torch.Tensor:
    """x [b, p, na, c], W [c, d], bias [d], ssk [1 or b, 2, na*d], y
    [b, p, na, d], ssm [1 or b, 2, na*d] -> [b, p, na, d] (x's type)."""
    b, p, na, d = y.shape
    sk = build.leaky(_conv_f32(x, W, bias) * ssk[:, 0:1] + ssk[:, 1:2])
    ym = build.leaky(build.widen(y).reshape(b, p, na * d) * ssm[:, 0:1]
                     + ssm[:, 1:2])
    return (ym + sk).to(x.dtype).reshape(b, p, na, d)


def grouped_conv_dx_plain(dout: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """dx [b, p, na, c] = dout [b, p, na, d] @ W^T in fp32, rounded to
    dout's type."""
    return (build.widen(dout) @ build.widen(W).t()).to(dout.dtype)


def grouped_conv_dw_plain(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dW [c, d] fp32 = x^T dout over every (point, anchor) row."""
    c, d = x.shape[-1], dout.shape[-1]
    return build.widen(x).reshape(-1, c).t() @ build.widen(dout).reshape(-1, d)


def _check(kernel, x, W, bias):
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, p, na, c = x.shape
    d = W.shape[-1]
    bf16 = build.dtype_flag(x.dtype, kernel)
    build.check_operands(kernel, dev, {
        'x': (x, x.dtype, (b, p, na, c)), 'W': (W, x.dtype, (c, d)),
        'bias': (bias, torch.float32, (d,))})
    _check_shape(kernel, b, p, na, c, d)
    return dev, b, p, na, c, d, bf16


def _check_shape(kernel, b, p, na, c, d):
    if c % 4 != 0 or d % 32 != 0 or b * p * na >= 2 ** 31:
        raise ValueError(f'{kernel}: kernel needs c % 4 == 0, d % 32 == 0 and '
                         f'b*p*na < 2^31; got b={b} p={p} na={na} c={c} d={d}')


def grouped_conv(x: torch.Tensor, W: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if x.device.type == 'cpu':
        return grouped_conv_plain(x, W, bias)
    dev, b, p, na, c, d, bf16 = _check('grouped_conv', x, W, bias)
    out = torch.empty((b, p, na, d), dtype=x.dtype, device=dev)
    launches['grouped_conv'] += 1
    build.launch('epn_grouped_conv', x.data_ptr(), W.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), b * p * na, c, d, bf16,
                 build.stream(x))
    return out


def grouped_conv_tail(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor,
                      ssk: torch.Tensor, y: torch.Tensor,
                      ssm: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if x.device.type == 'cpu':
        return grouped_conv_tail_plain(x, W, bias, ssk, y, ssm)
    dev, b, p, na, c, d, bf16 = _check('grouped_conv_tail', x, W, bias)
    L = na * d
    sb, mb = ssk.shape[0], ssm.shape[0]
    if sb not in (1, b) or mb not in (1, b):
        raise ValueError(f'grouped_conv_tail: the folds need a batch of 1 or '
                         f'{b}; got {sb} and {mb}')
    build.check_operands('grouped_conv_tail', dev, {
        'ssk': (ssk, torch.float32, (sb, 2, L)),
        'y': (y, x.dtype, (b, p, na, d)),
        'ssm': (ssm, torch.float32, (mb, 2, L))})
    out = torch.empty((b, p, na, d), dtype=x.dtype, device=dev)
    launches['grouped_conv_tail'] += 1
    build.launch('epn_grouped_conv_tail', x.data_ptr(), W.data_ptr(),
                 bias.data_ptr(), ssk.data_ptr(), y.data_ptr(), ssm.data_ptr(),
                 out.data_ptr(), b, p, na, c, d, 0 if sb == 1 else 2 * L,
                 0 if mb == 1 else 2 * L, bf16,
                 build.stream(x))
    return out


def grouped_conv_dx(dout: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """B9 dx wrapper: plain version on the CPU; on the card the plain conv
    kernel on (dout, W transposed to [d, c]) with no bias."""
    if dout.device.type == 'cpu':
        return grouped_conv_dx_plain(dout, W)
    kernel = 'grouped_conv_dx'
    dev = dout.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, p, na, d = dout.shape
    c = W.shape[0]
    bf16 = build.dtype_flag(dout.dtype, kernel)
    Wt = W.t().contiguous()
    build.check_operands(kernel, dev, {
        'dout': (dout, dout.dtype, (b, p, na, d)),
        'W': (Wt, dout.dtype, (d, c))})
    _check_shape(kernel, b, p, na, d, c)
    dx = torch.empty((b, p, na, c), dtype=dout.dtype, device=dev)
    launches[kernel] += 1
    build.launch('epn_grouped_conv', dout.data_ptr(), Wt.data_ptr(), 0,
                 dx.data_ptr(), b * p * na, d, c, bf16, build.stream(dout))
    return dx


def grouped_conv_dw(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """B9 dW wrapper: plain version on the CPU; on the card per-row-range
    partials summed in a fixed order (deterministic)."""
    if x.device.type == 'cpu':
        return grouped_conv_dw_plain(x, dout)
    kernel = 'grouped_conv_dw'
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, p, na, c = x.shape
    d = dout.shape[-1]
    bf16 = build.dtype_flag(x.dtype, kernel)
    build.check_operands(kernel, dev, {
        'x': (x, x.dtype, (b, p, na, c)),
        'dout': (dout, x.dtype, (b, p, na, d))})
    _check_shape(kernel, b, p, na, c, d)
    rows = b * p * na
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    splits = build.n_splits(-(-c // 128) * (d // bn), -(-rows // 16))
    ws = torch.empty((splits, c, d), dtype=torch.float32, device=dev)
    dW = torch.empty((c, d), dtype=torch.float32, device=dev)
    launches[kernel] += 1
    build.launch('epn_grouped_conv_bwd_w', x.data_ptr(), dout.data_ptr(),
                 ws.data_ptr(), dW.data_ptr(), rows, c, d, splits, bf16,
                 build.stream(x))
    return dW


class GroupedConvFn(torch.autograd.Function):
    """The grouped 1x1 conv with its hand-written backward (the
    ``grouped_conv1x1`` custom VJP): gradients to x, W and bias."""

    @staticmethod
    def forward(ctx, x, W, bias):
        ctx.save_for_backward(x, W)
        return grouped_conv(x, W, bias)

    @staticmethod
    def backward(ctx, dout):
        x, W = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dW = dbias = None
        if ctx.needs_input_grad[0]:
            dx = grouped_conv_dx(dout, W)
        if ctx.needs_input_grad[1]:
            dW = grouped_conv_dw(x, dout)
        if ctx.needs_input_grad[2]:
            dbias = build.widen(dout).sum(dim=(0, 1, 2))
        return dx, dW, dbias
