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
folds are fp32. Inference only (no backward).
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
    if c % 4 != 0 or d % 32 != 0 or b * p * na >= 2 ** 31:
        raise ValueError(f'{kernel}: kernel needs c % 4 == 0, d % 32 == 0 and '
                         f'b*p*na < 2^31; got b={b} p={p} na={na} c={c} d={d}')
    return dev, b, p, na, c, d, bf16


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
