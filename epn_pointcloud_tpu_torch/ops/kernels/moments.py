"""Per-lane moment sums (norm statistics): the CUDA kernel wrapper and its
plain version.

Replaces ``epn_pointcloud_tpu/ops/pallas/moments.py:moments_sums``
(``_moments_fwd`` -> ``_kernel``):

  x [b, rows, L] -> (sum_rows x, sum_rows x^2), each [b, L] fp32

from fp32 or bf16 input. The contract stays per-lane: callers fold the
lanes to per-(b, c) statistics in plain PyTorch (``nn/layers.py``).
``MomentsFn`` gives it the JAX package's backward (``_moments_bwd``), which
is elementwise plain code there too: dx = dsum + 2 x dsq.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = 'epn_pointcloud_tpu_torch/csrc/moments.cu'
# kernel entry -> (plain version, source, the TPU kernel it replaces)
ENTRIES = {
    'moments': ('moments_plain', SOURCE,
                'epn_pointcloud_tpu/ops/pallas/moments.py:65'),
}
launches = dict.fromkeys(ENTRIES, 0)


def moments_plain(x: torch.Tensor):
    """x [b, rows, L] -> (sum, sumsq) [b, L] fp32."""
    xf = build.widen(x)
    return xf.sum(dim=1), (xf * xf).sum(dim=1)


def moments(x: torch.Tensor):
    """Kernel wrapper: plain version on the CPU, CUDA kernel on the card."""
    if x.device.type == 'cpu':
        return moments_plain(x)
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'moments: unsupported device {dev}')
    b, rows, L = x.shape
    bf16 = build.dtype_flag(x.dtype, 'moments')
    build.check_operands('moments', dev, {'x': (x, x.dtype, (b, rows, L))})
    if L % 2 != 0 or not 1 <= b <= 65535:
        raise ValueError(f'moments: kernel needs an even L and 1 <= b <= '
                         f'65535; got b={b} rows={rows} L={L}')
    s = torch.empty((b, L), dtype=torch.float32, device=dev)
    sq = torch.empty((b, L), dtype=torch.float32, device=dev)
    launches['moments'] += 1
    build.launch('epn_moments', x.data_ptr(), s.data_ptr(), sq.data_ptr(), b,
                 rows, L, bf16, build.stream(x))
    return s, sq


class MomentsFn(torch.autograd.Function):
    """moments with its backward dx = dsum + 2 * x * dsq (fp32, rounded to
    x's type), so that the norms built on it stay differentiable in their
    statistics."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return moments(x)

    @staticmethod
    def backward(ctx, dsum, dsq):
        x, = ctx.saved_tensors
        dx = build.widen(x).new_zeros(())
        if dsum is not None:
            dx = dx + dsum[:, None, :]
        if dsq is not None:
            dx = dx + 2.0 * build.widen(x) * dsq[:, None, :]
        return dx.expand(x.shape).to(x.dtype)
