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
batch), act the leaky ReLU of a slope with mask ``u > 0`` (0.01; 0 for the
ReLU: ``build.ACT_SLOPES``, a launch argument of the kernel). Both compute in fp32 from
fp32 or bf16 operands and round once to the operand type; bias and the
folds are fp32. The plain conv has a backward, replacing ``_gc_bwd`` ->
``_bwd_kernel`` (``GroupedConvFn``), one kernel as the TPU body is:

  grouped_conv_bwd:   dx = dout @ W^T,  dW = x^T dout,
                      dbias = sum of dout (both over every (point, anchor)
                      row, fp32);

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
    'grouped_conv_bwd': ('grouped_conv_bwd_plain', SOURCE,
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
                            y: torch.Tensor, ssm: torch.Tensor,
                            slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """x [b, p, na, c], W [c, d], bias [d], ssk [1 or b, 2, na*d], y
    [b, p, na, d], ssm [1 or b, 2, na*d] -> [b, p, na, d] (x's type); act
    the leaky ReLU of ``slope``."""
    b, p, na, d = y.shape
    sk = build.leaky(_conv_f32(x, W, bias) * ssk[:, 0:1] + ssk[:, 1:2],
                     slope)
    ym = build.leaky(build.widen(y).reshape(b, p, na * d) * ssm[:, 0:1]
                     + ssm[:, 1:2], slope)
    return (ym + sk).to(x.dtype).reshape(b, p, na, d)


def grouped_conv_bwd_plain(x: torch.Tensor, W: torch.Tensor,
                          dout: torch.Tensor, parts: int = 3):
    """(dx, dW, dbias) of out = x @ W + bias for the cotangent dout
    [b, p, na, d]: dx [b, p, na, c] = dout @ W^T in fp32, rounded to dout's
    type (``parts`` bit 0); dW [c, d] = x^T dout and dbias [d] = the sum of
    dout over every (point, anchor) row, both fp32 (bit 1). A part not asked
    for is None."""
    c, d = W.shape
    dx = dW = dbias = None
    if parts & 1:
        dx = (build.widen(dout) @ build.widen(W).t()).to(dout.dtype)
    if parts & 2:
        d2 = dout.reshape(-1, d)
        dW = build.widen(x).reshape(-1, c).t() @ build.widen(d2)
        dbias = d2.sum(0, dtype=dW.dtype)
    return dx, dW, dbias


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
                      ssk: torch.Tensor, y: torch.Tensor, ssm: torch.Tensor,
                      slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """Kernel wrapper (act the leaky ReLU of ``slope``): plain version on
    the CPU, CUDA kernel on the card."""
    if x.device.type == 'cpu':
        return grouped_conv_tail_plain(x, W, bias, ssk, y, ssm, slope)
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
                 0 if mb == 1 else 2 * L, slope, bf16,
                 build.stream(x))
    return out


def _bwd_splits(rows, c, d, bf16):
    """Row ranges of the dW reduction: the bf16 kernel's block covers 32, 64
    or 128 columns of c and 32..256 of d over 64-row tiles (one block an SM
    at d > 128, where its shared memory allows no second); the fp32 one 128
    of c and 128, 64 or 32 of d over 16-row slices."""
    if bf16:
        ci = 32 if c <= 32 else 64 if c < 128 else 128
        tiles = -(-c // ci) * -(-d // 256)
        return build.n_splits(tiles, -(-rows // 64),
                              132 if d > 128 else 264)
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    return build.n_splits(-(-c // 128) * (d // bn), -(-rows // 16))


def grouped_conv_bwd(x: torch.Tensor, W: torch.Tensor, dout: torch.Tensor,
                     parts: int = 3):
    """B9 wrapper: plain version on the CPU; on the card one launch of the
    backward (bf16, d <= 256: dx, dW and dbias from one read of each row
    tile; else dx apart). dW and dbias are per-row-range partials added in a
    fixed order (deterministic)."""
    if x.device.type == 'cpu':
        return grouped_conv_bwd_plain(x, W, dout, parts)
    kernel = 'grouped_conv_bwd'
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, p, na, c = x.shape
    d = W.shape[-1]
    bf16 = build.dtype_flag(x.dtype, kernel)
    build.check_operands(kernel, dev, {
        'x': (x, x.dtype, (b, p, na, c)), 'W': (W, x.dtype, (c, d)),
        'dout': (dout, x.dtype, (b, p, na, d))})
    _check_shape(kernel, b, p, na, c, d)
    if not bf16 and parts & 1 and c % 32 != 0:
        raise ValueError(f'{kernel}: the fp32 dx needs c % 32 == 0; got c={c}')
    rows = b * p * na
    dx = torch.empty_like(x) if parts & 1 else None
    dW = dbias = ws = dwb = None
    splits = 1
    if parts & 2:
        splits = _bwd_splits(rows, c, d, bf16)
        ws = torch.empty((splits, c + 1, d), dtype=torch.float32, device=dev)
        dwb = torch.empty((c + 1, d), dtype=torch.float32, device=dev)
        dW, dbias = dwb[:c], dwb[c]
    launches[kernel] += 1
    build.launch('epn_grouped_conv_bwd', x.data_ptr(), W.data_ptr(),
                 dout.data_ptr(), 0 if dx is None else dx.data_ptr(),
                 0 if ws is None else ws.data_ptr(),
                 0 if dwb is None else dwb.data_ptr(), rows, c, d, splits,
                 parts, bf16, build.stream(x))
    return dx, dW, dbias


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
        need = ctx.needs_input_grad
        parts = (1 if need[0] else 0) | (2 if need[1] or need[2] else 0)
        if not parts:
            return None, None, None
        dx, dW, dbias = grouped_conv_bwd(x, W, dout.contiguous(), parts)
        return dx, dW if need[1] else None, dbias if need[2] else None
