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

The W-off kernels replace ``_call_gather`` -> ``_fwd_gather_kernel`` and
``_call`` -> ``_fwd_kernel`` (F without W: ``fused_gather_neighbor_conv``,
``fused_neighbor_conv``) and ``_call`` -> ``_bwd_kernel`` with the one-hot
fold after it (dG onto the table rows): ``inter_conv_f`` writes F
[b, p, a, k, c] and ``inter_conv_dg`` scatters sum_k w dF onto the table.
``InterConvFn``'s backward runs them where ``_fgcw_bwd`` composes its
backward from them (``composed_backward``), in either dtype, with dF and dW
as torch matmuls, as the JAX package leaves those to XLA.

The plain versions are anchor-chunked fp32 formulations (the forward that of
``epn_pointcloud_tpu/ops/so3conv.py`` ``inter_so3conv_fused``, XLA path), so
no [b, p, n, na, *] tensor for all anchors exists at once.

Forward and backward also run in bf16 (the production mode): the table, W,
out and dout are bf16, gx, rk and k2 stay fp32, and every sum is fp32; out
is rounded once, dW stays fp32 and dT is rounded to the table's type after
its fp32 sums, as ``_fgcw_bwd`` rounds its fp32 dTable. The bf16 forward
runs on tensor cores (``mma_route``; other shapes on the SGEMM template):
both round the anchor weights and F to bf16 before the product each feeds,
where the TPU kernel rounds them (``_fwd_gather_w_kernel:974, 980``; their
reference ``inter_conv_mma_plain``); the plain version keeps both in fp32,
which puts ~3e-3 (normwise) between the kernels and the plain version. The
fp32 forward runs its own CUDA-core kernel (``fwd_f32_route``; other fp32
shapes on the template), F summed in the template's order (bitwise the
template's F), the W product summed in fp32. The
W-off kernels keep the composed route's bf16 rounding points
(``_fgcw_bwd:1685-1703``): the anchor weights, F and dF in the table's
type, each neighbor slot's sum_k w dF rounded to bf16 before the fp32 fold
onto the table rows, dW summed in fp32. The bf16 backward scatter (the
fused dTable and the W-off dG) runs on tensor cores (``bwd_mma_route``;
other shapes on the template) at the TPU kernels' rounding points, as its
plain versions do: dF, the anchor weights and each slot's sum rounded to
bf16, the fold onto the table rows in fp32. The fp32 backward scatter runs
its own CUDA-core kernel (``bwd_f32_route``; other fp32 shapes on the
template), fp32 sums with no rounding points. The bf16 fused dW runs on
tensor cores (``dw_mma_route``; other shapes on the template); both round
the anchor weights and F to bf16 before the fp32 product, where the TPU
kernels round them (``_bwd_gather_w_kernel:1133, 1140``), as the plain
version does. The fp32 fused dW runs its own CUDA-core kernel
(``dw_f32_route``; other fp32 shapes on the template), F built in fp32 and
summed in the template's order, dW summed in fp32. The bf16 W-off F runs
on tensor cores (``f_mma_route``) at the same rounding points as its plain
version: the anchor weights rounded to bf16, fp32 sums, F rounded once. The
fp32 W-off F runs its own CUDA-core kernel (``f_f32_route``), F summed in
the template's order (bitwise the template's). Other shapes run the SGEMM
template's W-off mode.
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
    'inter_conv_f': ('inter_conv_f_plain', SOURCE,
                     'epn_pointcloud_tpu/ops/pallas/inter_conv.py:622'),
    'inter_conv_dg': ('inter_conv_dg_plain', BWD_SOURCE,
                      'epn_pointcloud_tpu/ops/pallas/inter_conv.py:559'),
}
launches = dict.fromkeys(ENTRIES, 0)
# launches by kernel: the forward's 'mma', the bf16 tensor-core kernel
# (``inter_conv_mma_kernel``), 'fwd_f32', the fp32 CUDA-core kernel
# (``inter_fwd_f32_kernel``), or 'sgemm', the register-blocked SGEMM
# template (shapes off both routes); the backward
# scatter's 'dtable_mma' and 'dg_mma', the bf16 tensor-core kernel
# (``inter_bwd_mma_kernel``), 'dtable_f32' and 'dg_f32', the fp32 CUDA-core
# kernel (``inter_bwd_f32_kernel``), or 'dtable' and 'dg', the template
# (``inter_dtable_kernel``: shapes off both routes);
# the fused dW's 'dw_mma', the bf16 tensor-core kernel
# (``inter_dw_mma_kernel``), 'dw_f32', the fp32 CUDA-core kernel
# (``inter_dw_f32_kernel``), or 'dw', the template (``inter_dw_kernel``:
# shapes off both routes); the W-off F's 'f_mma', the
# bf16 tensor-core kernel (``inter_f_mma_kernel``), 'f_f32', the fp32
# CUDA-core kernel (``inter_f_f32_kernel``), or 'f', the SGEMM template's
# W-off mode (shapes off both routes)
routes = dict.fromkeys(('mma', 'fwd_f32', 'sgemm', 'dtable_mma', 'dtable_f32',
                        'dtable', 'dg_mma', 'dg_f32', 'dg', 'dw_mma', 'dw_f32',
                        'dw', 'f_mma', 'f_f32', 'f'), 0)

# anchors per step of the plain versions: bounds their [b, p, n, chunk, *]
# intermediates (~1 GB at b=32 on the widest flagship layer)
ANCHOR_CHUNK = 10
# the backward kernels are written for the model's 24 kernel points
N_KERNEL = 24
# the bf16 tensor-core forward's envelope (``mma_route``): neighbors up to,
# and the fewest anchors (a block's 64 rows touch 64 / na + 2 points)
MMA_MAX_NN, MMA_MIN_NA = 64, 4
# the fp32 CUDA-core forward's envelope (``fwd_f32_route``): the anchors, a
# multiple of the channels (its chunk), of d, neighbors up to
FWD_F32_NA, FWD_F32_CC, FWD_F32_SD, FWD_F32_MAX_NN = 60, 16, 32, 64
# the W-off kernels' envelope (the composed layers of the inv and reg
# models, at any anchor count): channels and neighbors up to
WOFF_MAX_C, WOFF_MAX_NN = 128, 64
# the bf16 tensor-core backward scatter's envelope (``bwd_mma_route``): the
# anchors, a multiple of the channels, neighbors up to, a multiple of d
BWD_MMA_NA, BWD_MMA_CC, BWD_MMA_MAX_NN, BWD_MMA_SD = 60, 16, 64, 32
# the fp32 CUDA-core backward scatter's envelope (``bwd_f32_route``): the
# anchors, a multiple of the channels, neighbors up to, a multiple of d
BWD_F32_NA, BWD_F32_CC, BWD_F32_MAX_NN, BWD_F32_SD = 60, 16, 64, 16
# its fused entry's tiles: the rows of its dF product (a point's anchors,
# padded)
BWD_F32_ROWS = 64
# the bf16 tensor-core dW's envelope (``dw_mma_route``): the anchors, a
# block's channels and columns (multiples of both), neighbors up to; and
# the blocks its row splits aim for (one block an SM: about two waves)
DW_MMA_NA, DW_MMA_CC, DW_MMA_BN, DW_MMA_MAX_NN = 60, 16, 64, 64
DW_MMA_BLOCKS = 256
# the fp32 CUDA-core dW's envelope (``dw_f32_route``): the anchors, a
# block's channels and its kernel points (a multiple of the channels and
# the kernel size), a multiple of d, neighbors up to; its row tile; and,
# by the d columns a block, the blocks its row splits aim for: four waves
# at the blocks an SM holds (one at 256 columns, two below)
DW_F32_NA, DW_F32_CC, DW_F32_KP, DW_F32_D, DW_F32_MAX_NN = 60, 16, 8, 64, 64
DW_F32_BM = 32
DW_F32_BLOCKS = {64: 1056, 128: 1056, 256: 528}
# the bf16 tensor-core W-off F's envelope (``f_mma_route``): the anchors, a
# multiple of the channels (its chunk), neighbors up to
F_MMA_NA, F_MMA_CC, F_MMA_MAX_NN = 60, 32, 64
# the fp32 CUDA-core W-off F's envelope (``f_f32_route``): the anchors, a
# multiple of the channels (its narrower chunk), neighbors up to
F_F32_NA, F_F32_CC, F_F32_MAX_NN = 60, 16, 64


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


def _f_chunks(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
              rk: torch.Tensor, k2: torch.Tensor, sigma: float,
              rounded: bool = False):
    """(s, e, F [b, p2, e - s, K, c]) for each anchor chunk [s, e): the
    neighbor contraction in fp32 over the shadow-padded table; rounded: the
    anchor weights rounded to bf16 before it and F after it (values kept in
    fp32)."""
    b = idx.shape[0]
    na, c = table.shape[2], table.shape[3]
    table = build.widen(table)
    table = torch.cat([table, table.new_zeros(b, 1, na, c)], dim=1)
    idx = idx.long()
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)          # [b,p,n,ac,K]
        if rounded:
            w = _round_bf16(w)
        G = _gather_chunk(table, idx, s, e)                  # [b,p,n,ac,c]
        F = torch.einsum('bpnak,bpnac->bpakc', w, G)
        yield s, e, _round_bf16(F) if rounded else F


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _scatter_rows(gx: torch.Tensor, idx: torch.Tensor, q: int,
                  rk: torch.Tensor, k2: torch.Tensor, dF_chunk, c: int,
                  sigma: float, rounded: bool = False) -> torch.Tensor:
    """dT [b, q, na, c] fp32: each neighbor slot's sum_k w dF scattered onto
    its table row (the shadow row dropped) in fp32; dF_chunk(s, e) gives dF
    [b, p2, e - s, K, c] of anchors [s, e). rounded: the anchor weights
    rounded to bf16 before the sum and each slot's sum after it, as the TPU
    kernels round them in bf16 (``_bwd_gather_w_kernel:1133, 1158``,
    ``_bwd_kernel:573, 580-581``; values kept in fp32)."""
    b, p2, nn = idx.shape
    na = rk.shape[0]
    # flat row of (b, idx) in the shadow-padded [b * (q + 1)] table
    rows = (idx.long() + (q + 1) * torch.arange(
        b, device=idx.device)[:, None, None]).reshape(-1)
    dT = gx.new_zeros(b * (q + 1), na, c)
    for s in range(0, na, ANCHOR_CHUNK):
        e = min(s + ANCHOR_CHUNK, na)
        w = anchor_weights(gx, rk[s:e], k2, sigma)          # [b,p,n,ac,K]
        if rounded:
            w = _round_bf16(w)
        g = torch.einsum('bpnak,bpakc->bpnac', w, dF_chunk(s, e))
        if rounded:
            g = _round_bf16(g)
        dT[:, s:e] = dT[:, s:e].index_add(0, rows, g.reshape(-1, e - s, c))
    return dT.reshape(b, q + 1, na, c)[:, :q]


def inter_conv_plain(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                     rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """gx [b, p2, nn, 3], idx [b, p2, nn] in [0, q], table [b, q, na, c],
    rk [na, K, 3], k2 [K], W [K, c, d] -> out [b, p2, na, d] (fp32
    arithmetic, rounded to the table's type)."""
    return _plain_forward(gx, idx, table, rk, k2, W, sigma, False)


def inter_conv_mma_plain(gx: torch.Tensor, idx: torch.Tensor,
                         table: torch.Tensor, rk: torch.Tensor,
                         k2: torch.Tensor, W: torch.Tensor,
                         sigma: float) -> torch.Tensor:
    """The bf16 kernels' arithmetic (a bf16 table and W): the anchor
    weights and F rounded to bf16 before the product each feeds, where the
    TPU kernel rounds them (``_fwd_gather_w_kernel:974, 980``,
    ``_build_packed_fs:287, 299``), fp32 sums, out rounded once. The
    kernels' reference at the rounding points they share with the TPU.
    ``inter_conv_plain`` stays the wrapper's plain version (its CPU path and
    the op layer's plain path) in fp32 inside: at these rounding points the
    port's bf16 CPU step meets block 0's skip BatchNorm bias gradient at a
    cosine of 0.91-0.97 to float64 (0.92-0.99 in fp32 inside, the JAX
    package's 0.98-0.995), below tests/test_torch_port_bf16_train.py's
    0.93 on four of six 1e-6 scalings of its batch (ROADMAP section C)."""
    return _plain_forward(gx, idx, table, rk, k2, W, sigma, True)


def _plain_forward(gx, idx, table, rk, k2, W, sigma, rounded):
    b, p2, _ = idx.shape
    K, c, d = W.shape
    W2 = build.widen(W).reshape(K * c, d)
    outs = [(F.reshape(-1, K * c) @ W2).reshape(b, p2, e - s, d)
            for s, e, F in _f_chunks(gx, idx, table, rk, k2, sigma,
                                     rounded)]
    return torch.cat(outs, dim=2).to(table.dtype)


def inter_conv_dtable_plain(gx: torch.Tensor, idx: torch.Tensor, q: int,
                            rk: torch.Tensor, k2: torch.Tensor,
                            W: torch.Tensor, dout: torch.Tensor,
                            sigma: float) -> torch.Tensor:
    """dT [b, q, na, c] fp32 from dout [b, p2, na, d]: each neighbor slot's
    sum_k w dF scattered onto its table row (the shadow row dropped). From
    bf16 operands, at the TPU kernel's rounding points
    (``_bwd_gather_w_kernel``): dF = dout W^T summed in fp32 and rounded to
    bf16 (:1120), the anchor weights (:1133) and each slot's sum (:1158)
    rounded to bf16, the fold onto the table rows in fp32 (:1166)."""
    rounded = dout.dtype == torch.bfloat16
    dout, W = build.widen(dout), build.widen(W)

    def dF(s, e):
        f = torch.einsum('bpad,kcd->bpakc', dout[:, :, s:e], W)
        return _round_bf16(f) if rounded else f
    return _scatter_rows(gx, idx, q, rk, k2, dF, W.shape[1], sigma, rounded)


def inter_conv_dw_plain(gx: torch.Tensor, idx: torch.Tensor,
                        table: torch.Tensor, rk: torch.Tensor,
                        k2: torch.Tensor, dout: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """dW [K, c, d] fp32 = sum over (b, p, a) of F^T dout, summed in fp32.
    From a bf16 table the anchor weights are rounded to bf16 before the
    neighbor contraction and F after it, where the TPU kernels round them
    before their dW product (``_bwd_gather_w_kernel:1133, 1140``,
    ``_bwd_kernel_dw2:1309, 1315``)."""
    dout = build.widen(dout)
    dW = dout.new_zeros(rk.shape[1], table.shape[3], dout.shape[-1])
    for s, e, F in _f_chunks(gx, idx, table, rk, k2, sigma,
                             table.dtype == torch.bfloat16):
        dW += torch.einsum('bpakc,bpad->kcd', F, dout[:, :, s:e])
    return dW


def inter_conv_f_plain(gx: torch.Tensor, idx: torch.Tensor,
                       table: torch.Tensor, rk: torch.Tensor,
                       k2: torch.Tensor, sigma: float) -> torch.Tensor:
    """W-off forward: F [b, p2, na, K, c] summed in fp32 and rounded once to
    the table's type; from a bf16 table the anchor weights are rounded to
    bf16 first, as the TPU kernel rounds them (``_conv_body:516``). The
    layout makes dW one [K*c, b*p2*na] x [b*p2*na, d] product."""
    rounded = table.dtype == torch.bfloat16
    return torch.cat([F.to(table.dtype) for _, _, F in _f_chunks(
        gx, idx, table, rk, k2, sigma, rounded)], dim=2)


def inter_conv_dg_plain(gx: torch.Tensor, idx: torch.Tensor, q: int,
                        rk: torch.Tensor, k2: torch.Tensor, dF: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """W-off backward: dT [b, q, na, c] fp32 from dF [b, p2, na, K, c], the
    index_add of sum_k w dF over the shadow-padded rows in fp32; from a bf16
    dF (widened) the anchor weights and each slot's sum are rounded to bf16
    first, as the TPU kernel rounds the weights (``_bwd_kernel:573``) and
    stores dG in dF's dtype (:580-581) before its fp32 fold."""
    return _scatter_rows(gx, idx, q, rk, k2,
                         lambda s, e: build.widen(dF[:, :, s:e]),
                         dF.shape[-1], sigma, dF.dtype == torch.bfloat16)


def _check(kernel, gx, idx, table_shape, rk, k2, W_shape, dout=None,
           table=None, W=None, dtype=torch.float32):
    """Device, dtype, shape, contiguity and kernel-shape checks shared by the
    three wrappers (dtype: that of the table, W and dout); returns
    (b, p2, nn, q, na, K, c, d)."""
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
        want['table'] = (table, dtype, (b, q, na, c))
    if W is not None:
        want['W'] = (W, dtype, (K, c, d))
    if dout is not None:
        want['dout'] = (dout, dtype, (b, p2, na, d))
    build.check_operands(kernel, dev, want)
    if (c % 8 != 0 or K % 6 != 0 or d % 32 != 0 or nn < 1
            or b * p2 * na >= 2 ** 31):
        raise ValueError(f'{kernel}: kernel needs c % 8 == 0, K % 6 == 0, '
                         f'd % 32 == 0, nn >= 1 and b*p2*na < 2^31; got '
                         f'b={b} p2={p2} na={na} nn={nn} K={K} c={c} d={d}')
    return b, p2, nn, q, na, K, c, d


def mma_route(dtype, K: int, c: int, d: int, nn: int, na: int) -> bool:
    """Whether the forward runs the bf16 tensor-core kernel: a bf16 table
    and K == 24, c % 32 == 0, d % 32 == 0, nn <= MMA_MAX_NN and na >=
    MMA_MIN_NA (every layer of both models). fp32 and the other shapes the
    wrapper takes (c % 8 == 0, K % 6 == 0, d % 32 == 0) run the CUDA-core
    kernel (``fwd_f32_route``) or the SGEMM template."""
    return (dtype == torch.bfloat16 and K == N_KERNEL and c % 32 == 0
            and d % 32 == 0 and nn <= MMA_MAX_NN and na >= MMA_MIN_NA)


def fwd_f32_route(dtype, K: int, c: int, d: int, nn: int, na: int) -> bool:
    """Whether the forward runs the fp32 CUDA-core kernel
    (``inter_fwd_f32_kernel``): an fp32 table and K == 24, na == 60, c % 16
    == 0, d % 32 == 0 and 1 <= nn <= 64 (every layer of both models). bf16
    and the other shapes the wrapper takes run the tensor-core kernel
    (``mma_route``) or the SGEMM template."""
    return (dtype == torch.float32 and K == N_KERNEL and na == FWD_F32_NA
            and c % FWD_F32_CC == 0 and d % FWD_F32_SD == 0
            and 1 <= nn <= FWD_F32_MAX_NN)


def bwd_mma_route(dtype, K: int, c: int, nn: int, na: int,
                  d: int | None = None) -> bool:
    """Whether the backward scatter, the fused dTable (``d`` given) or the
    W-off dG, runs the bf16 tensor-core kernel (``inter_bwd_mma_kernel``):
    a bf16 dout or dF and K == 24, na == 60, c % 16 == 0, 1 <= nn <= 64 and
    d % 32 == 0 (every layer of both models). fp32 and the other shapes the
    wrappers take run the CUDA-core kernel (``bwd_f32_route``) or the
    template (``inter_dtable_kernel``)."""
    return (dtype == torch.bfloat16 and K == N_KERNEL and na == BWD_MMA_NA
            and c % BWD_MMA_CC == 0 and 1 <= nn <= BWD_MMA_MAX_NN
            and (d is None or d % BWD_MMA_SD == 0))


def bwd_f32_route(dtype, K: int, c: int, nn: int, na: int,
                  d: int | None = None) -> bool:
    """Whether the backward scatter, the fused dTable (``d`` given) or the
    W-off dG, runs the fp32 CUDA-core kernel (``inter_bwd_f32_kernel``): an
    fp32 dout or dF and K == 24, na == 60, c % 16 == 0, 1 <= nn <= 64 and
    d % 16 == 0 (every layer of both models). bf16 and the other shapes the
    wrappers take run the tensor-core kernel (``bwd_mma_route``) or the
    template (``inter_dtable_kernel``)."""
    return (dtype == torch.float32 and K == N_KERNEL and na == BWD_F32_NA
            and c % BWD_F32_CC == 0 and 1 <= nn <= BWD_F32_MAX_NN
            and (d is None or d % BWD_F32_SD == 0))


def dw_mma_route(dtype, K: int, c: int, d: int, nn: int, na: int) -> bool:
    """Whether the fused dW runs the bf16 tensor-core kernel
    (``inter_dw_mma_kernel``): a bf16 table and K == 24, na == 60, c % 16
    == 0, d % 64 == 0 and 1 <= nn <= 64 (every fused-route layer of both
    models). fp32 and the other shapes the wrapper takes run the template
    (``inter_dw_kernel``)."""
    return (dtype == torch.bfloat16 and K == N_KERNEL and na == DW_MMA_NA
            and c % DW_MMA_CC == 0 and d % DW_MMA_BN == 0
            and 1 <= nn <= DW_MMA_MAX_NN)


def dw_f32_route(dtype, K: int, c: int, d: int, nn: int, na: int) -> bool:
    """Whether the fused dW runs the fp32 CUDA-core kernel
    (``inter_dw_f32_kernel``): an fp32 table and K == 24, na == 60, c % 16
    == 0, d % 64 == 0 and 1 <= nn <= 64 (every fused-route layer of both
    models). bf16 and the other shapes the wrapper takes run the tensor-core
    kernel (``dw_mma_route``) or the template (``inter_dw_kernel``)."""
    return (dtype == torch.float32 and K == N_KERNEL and na == DW_F32_NA
            and c % DW_F32_CC == 0 and d % DW_F32_D == 0
            and 1 <= nn <= DW_F32_MAX_NN)


def dw_f32_cols(d: int) -> int:
    """d columns a block of the fp32 CUDA-core dW: all of d up to 256. The
    wrapper passes it to the kernel, which launches that grid."""
    return 256 if d % 256 == 0 else 128 if d % 128 == 0 else 64


def f_mma_route(dtype, K: int, c: int, nn: int, na: int) -> bool:
    """Whether the W-off F runs the bf16 tensor-core kernel
    (``inter_f_mma_kernel``): a bf16 table and K == 24, na == 60, c % 32 ==
    0 and 1 <= nn <= 64 (every composed-route layer of the inv model). fp32
    and the other shapes the wrapper takes run the CUDA-core kernel
    (``f_f32_route``) or the SGEMM template's W-off mode."""
    return (dtype == torch.bfloat16 and K == N_KERNEL and na == F_MMA_NA
            and c % F_MMA_CC == 0 and 1 <= nn <= F_MMA_MAX_NN)


def f_f32_route(dtype, K: int, c: int, nn: int, na: int) -> bool:
    """Whether the W-off F runs the fp32 CUDA-core kernel
    (``inter_f_f32_kernel``): an fp32 table and K == 24, na == 60, c % 16
    == 0 and 1 <= nn <= 64 (every composed-route layer of the inv model).
    bf16 and the other shapes the wrapper takes run the tensor-core kernel
    (``f_mma_route``) or the SGEMM template's W-off mode."""
    return (dtype == torch.float32 and K == N_KERNEL and na == F_F32_NA
            and c % F_F32_CC == 0 and 1 <= nn <= F_F32_MAX_NN)


def bwd_f32_workspace(b: int, p2: int, K: int, c: int, d: int) -> int:
    """fp32 floats of the CUDA-core fused dTable's workspace: W^T [c / 16,
    d, K, 16], then dout^T [b * p2, d, BWD_F32_ROWS] (a point's rows),
    which the C entry writes before its kernel runs."""
    return K * c * d + b * p2 * d * BWD_F32_ROWS


def inter_conv(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
               rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """Forward kernel wrapper: plain version on the CPU, CUDA kernel on the
    card: the tensor-core kernel where ``mma_route`` holds (bf16), the
    CUDA-core kernel where ``fwd_f32_route`` holds (fp32), else the SGEMM
    template. All are deterministic (no atomics)."""
    if table.device.type == 'cpu':
        return inter_conv_plain(gx, idx, table, rk, k2, W, sigma)
    bf16 = build.dtype_flag(table.dtype, 'inter_conv')
    b, p2, nn, q, na, K, c, d = _check('inter_conv', gx, idx, table.shape, rk,
                                       k2, W.shape, table=table, W=W,
                                       dtype=table.dtype)
    out = torch.empty((b, p2, na, d), dtype=table.dtype, device=gx.device)
    ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr(), W.data_ptr(), out.data_ptr(), b, p2, nn, q, na, K,
            c, d, float(sigma))
    launches['inter_conv'] += 1
    if mma_route(table.dtype, K, c, d, nn, na):
        route, entry, tail = 'mma', 'epn_inter_conv_mma', ()
    elif fwd_f32_route(table.dtype, K, c, d, nn, na):
        route, entry, tail = 'fwd_f32', 'epn_inter_conv_fwd_f32', ()
    else:
        route, entry, tail = 'sgemm', 'epn_inter_conv', (bf16,)
    routes[route] += 1
    build.launch(entry, *ptrs, *tail, build.stream(table))
    return out


def inter_conv_dtable(gx: torch.Tensor, idx: torch.Tensor, q: int,
                      rk: torch.Tensor, k2: torch.Tensor, W: torch.Tensor,
                      dout: torch.Tensor, sigma: float) -> torch.Tensor:
    """dTable kernel wrapper -> fp32 dT: plain version on the CPU, CUDA
    kernel on the card: the tensor-core kernel where ``bwd_mma_route`` holds
    (bf16), the CUDA-core kernel where ``bwd_f32_route`` holds (fp32; its
    operands transposed into a workspace, ``bwd_f32_workspace``), else the
    template. Their atomics make dT's last-bit rounding vary between
    runs."""
    if dout.device.type == 'cpu':
        return inter_conv_dtable_plain(gx, idx, q, rk, k2, W, dout, sigma)
    shape = (idx.shape[0], q, rk.shape[0], W.shape[1])
    bf16 = build.dtype_flag(dout.dtype, 'inter_conv_dtable')
    b, p2, nn, q, na, K, c, d = _check('inter_conv_dtable', gx, idx, shape,
                                       rk, k2, W.shape, dout=dout, W=W,
                                       dtype=dout.dtype)
    if K != N_KERNEL:
        raise ValueError(f'inter_conv_dtable: kernel needs K == {N_KERNEL}; '
                         f'got K={K}')
    dT = torch.zeros(shape, dtype=torch.float32, device=dout.device)
    ptrs = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(), k2.data_ptr(),
            W.data_ptr(), dout.data_ptr(), dT.data_ptr(), b, p2, nn, q, na,
            K, c, d, float(sigma))
    launches['inter_conv_dtable'] += 1
    if bwd_mma_route(dout.dtype, K, c, nn, na, d):
        route, entry, tail = 'dtable_mma', 'epn_inter_conv_bwd_table_mma', ()
    elif bwd_f32_route(dout.dtype, K, c, nn, na, d):
        ws = torch.empty(bwd_f32_workspace(b, p2, K, c, d),
                         dtype=torch.float32, device=dout.device)
        route, entry, tail = ('dtable_f32', 'epn_inter_conv_bwd_table_f32',
                              (ws.data_ptr(),))
    else:
        route, entry, tail = 'dtable', 'epn_inter_conv_bwd_table', (bf16,)
    routes[route] += 1
    build.launch(entry, *ptrs, *tail, build.stream(dout))
    return dT


def dw_splits(M: int, c: int, d: int, route: str, bn: int = 0) -> int:
    """Row ranges of a dW call over M rows on ``route`` ('dw_mma',
    'dw_f32' or 'dw'): the tensor-core kernel's blocks own 16 channels and
    64 columns over 64-row tiles and run one an SM, so they aim for
    DW_MMA_BLOCKS; the fp32 kernel's own 8 kernel points, 16 channels and
    ``bn`` columns (default ``dw_f32_cols(d)``) over 32-row tiles
    (DW_F32_BLOCKS); the template's own 8 channels and 64 or 128 columns
    over 64-row tiles, several an SM."""
    if route == 'dw_mma':
        return build.n_splits((d // DW_MMA_BN) * (c // DW_MMA_CC),
                              -(-M // 64), DW_MMA_BLOCKS)
    if route == 'dw_f32':
        bn = bn or dw_f32_cols(d)
        return build.n_splits((N_KERNEL // DW_F32_KP) * (d // bn)
                              * (c // DW_F32_CC), -(-M // DW_F32_BM),
                              DW_F32_BLOCKS[bn])
    bn = 128 if d % 128 == 0 else 64
    return build.n_splits((d // bn) * (c // 8), -(-M // 64))


def inter_conv_dw(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                  rk: torch.Tensor, k2: torch.Tensor, dout: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """dW kernel wrapper -> fp32 dW: plain version on the CPU, CUDA kernel on
    the card: the tensor-core kernel where ``dw_mma_route`` holds (bf16),
    the fp32 CUDA-core kernel where ``dw_f32_route`` holds, else the
    template. All sum per-row-range partials in a fixed order:
    deterministic."""
    if dout.device.type == 'cpu':
        return inter_conv_dw_plain(gx, idx, table, rk, k2, dout, sigma)
    W_shape = (rk.shape[1], table.shape[3], dout.shape[-1])
    bf16 = build.dtype_flag(table.dtype, 'inter_conv_dw')
    b, p2, nn, q, na, K, c, d = _check('inter_conv_dw', gx, idx, table.shape,
                                       rk, k2, W_shape, dout=dout, table=table,
                                       dtype=table.dtype)
    if K != N_KERNEL or d % 64 != 0:
        raise ValueError(f'inter_conv_dw: kernel needs K == {N_KERNEL} and '
                         f'd % 64 == 0; got K={K} d={d}')
    route = ('dw_mma' if dw_mma_route(table.dtype, K, c, d, nn, na) else
             'dw_f32' if dw_f32_route(table.dtype, K, c, d, nn, na) else
             'dw')
    splits = dw_splits(b * p2 * na, c, d, route)
    dev = dout.device
    ws = torch.empty((splits, K, c, d), dtype=torch.float32, device=dev)
    dW = torch.empty((K, c, d), dtype=torch.float32, device=dev)
    ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr(), dout.data_ptr(), ws.data_ptr(), dW.data_ptr(), b,
            p2, nn, q, na, K, c, d, float(sigma), splits)
    entry, tail = {'dw_mma': ('epn_inter_conv_bwd_w_mma', ()),
                   'dw_f32': ('epn_inter_conv_bwd_w_f32', (dw_f32_cols(d),)),
                   'dw': ('epn_inter_conv_bwd_w', (bf16,))}[route]
    launches['inter_conv_dw'] += 1
    routes[route] += 1
    build.launch(entry, *ptrs, *tail, build.stream(dout))
    return dW


def _check_woff(kernel, gx, idx, table_shape, rk, k2, dtype, F=None,
                table=None):
    """Checks of the W-off kernels (the table or dF in ``dtype``, fp32 or
    bf16; K == 24, c % 8 == 0 up to WOFF_MAX_C, 1 <= nn <= WOFF_MAX_NN,
    na >= 1: the redesigned kernels take 60 anchors, the template any);
    returns (b, p2, nn, q, na, K, c)."""
    dev = gx.device
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    b, q, na, c = table_shape
    _, p2, nn = idx.shape
    K = rk.shape[1]
    want = {'gx': (gx, torch.float32, (b, p2, nn, 3)),
            'idx': (idx, torch.int32, (b, p2, nn)),
            'rk': (rk, torch.float32, (na, K, 3)),
            'k2': (k2, torch.float32, (K,))}
    if table is not None:
        want['table'] = (table, dtype, (b, q, na, c))
    if F is not None:
        want['dF'] = (F, dtype, (b, p2, na, K, c))
    build.check_operands(kernel, dev, want)
    if (K != N_KERNEL or c % 8 != 0 or not 8 <= c <= WOFF_MAX_C
            or not 1 <= nn <= WOFF_MAX_NN or na < 1
            or b * p2 * na >= 2 ** 31):
        raise ValueError(f'{kernel}: kernel needs K == {N_KERNEL}, c % 8 == 0 '
                         f'and c <= {WOFF_MAX_C}, 1 <= nn <= {WOFF_MAX_NN}, '
                         f'na >= 1 and b*p2*na < 2^31; got b={b} '
                         f'p2={p2} na={na} nn={nn} K={K} c={c}')
    return b, p2, nn, q, na, K, c


def inter_conv_f(gx: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                 rk: torch.Tensor, k2: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """W-off forward wrapper -> F [b, p2, na, K, c] in the table's type
    (fp32 or bf16): plain version on the CPU, CUDA kernel on the card: the
    tensor-core kernel where ``f_mma_route`` holds (bf16), the CUDA-core
    kernel where ``f_f32_route`` holds (fp32), else (below 60 anchors, or
    other shapes) the SGEMM template's W-off mode. All are deterministic
    (no atomics)."""
    if table.device.type == 'cpu':
        return inter_conv_f_plain(gx, idx, table, rk, k2, sigma)
    bf16 = build.dtype_flag(table.dtype, 'inter_conv_f')
    b, p2, nn, q, na, K, c = _check_woff('inter_conv_f', gx, idx, table.shape,
                                         rk, k2, table.dtype, table=table)
    F = torch.empty((b, p2, na, K, c), dtype=table.dtype, device=gx.device)
    ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr(), F.data_ptr(), b, p2, nn, q, na, K, c,
            float(sigma))
    launches['inter_conv_f'] += 1
    if f_mma_route(table.dtype, K, c, nn, na):
        route, entry, tail = 'f_mma', 'epn_inter_conv_f_mma', ()
    elif f_f32_route(table.dtype, K, c, nn, na):
        route, entry, tail = 'f_f32', 'epn_inter_conv_f_f32', ()
    else:
        route, entry, tail = 'f', 'epn_inter_conv_f', (bf16,)
    routes[route] += 1
    build.launch(entry, *ptrs, *tail, build.stream(table))
    return F


def inter_conv_dg(gx: torch.Tensor, idx: torch.Tensor, q: int,
                  rk: torch.Tensor, k2: torch.Tensor, dF: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """W-off backward wrapper -> fp32 dT [b, q, na, c] from dF
    [b, p2, na, K, c] (fp32 or bf16): plain version on the CPU, CUDA kernel
    on the card: the tensor-core kernel where ``bwd_mma_route`` holds
    (bf16), the CUDA-core kernel where ``bwd_f32_route`` holds (fp32), else
    (below 60 anchors, or other shapes) the template. Their atomics make
    dT's last-bit rounding vary between runs."""
    if dF.device.type == 'cpu':
        return inter_conv_dg_plain(gx, idx, q, rk, k2, dF, sigma)
    bf16 = build.dtype_flag(dF.dtype, 'inter_conv_dg')
    shape = (idx.shape[0], q, rk.shape[0], dF.shape[-1])
    b, p2, nn, q, na, K, c = _check_woff('inter_conv_dg', gx, idx, shape, rk,
                                         k2, dF.dtype, F=dF)
    dT = torch.zeros(shape, dtype=torch.float32, device=dF.device)
    ptrs = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(), k2.data_ptr(),
            dF.data_ptr(), dT.data_ptr(), b, p2, nn, q, na, K, c,
            float(sigma))
    launches['inter_conv_dg'] += 1
    if bwd_mma_route(dF.dtype, K, c, nn, na):
        route, entry, tail = 'dg_mma', 'epn_inter_conv_dg_mma', ()
    elif bwd_f32_route(dF.dtype, K, c, nn, na):
        route, entry, tail = 'dg_f32', 'epn_inter_conv_dg_f32', ()
    else:
        route, entry, tail = 'dg', 'epn_inter_conv_dg', (bf16,)
    routes[route] += 1
    build.launch(entry, *ptrs, *tail, build.stream(dF))
    return dT


def composed_backward(c: int, nn: int) -> bool:
    """Whether ``InterConvFn`` takes the composed backward, exactly where
    ``epn_pointcloud_tpu/ops/pallas/inter_conv.py`` ``_fgcw_bwd:1675`` does:
    it keeps its fused backward only for c > 32 and tp > 2, with tp = 128 /
    nt and nt the least power of two >= max(16, nn); so c <= 32 or nn > 32
    composes."""
    return c <= 32 or nn > 32


def dw_product(F2: torch.Tensor, dout2: torch.Tensor) -> torch.Tensor:
    """The composed route's dW = F2^T dout2 [K*c, d] in fp32, summed in fp32
    end to end as ``_fgcw_bwd:1699-1701``'s ``preferred_element_type=float32``
    einsum. A bf16 product on the card asks cuBLAS for an fp32 output, so
    the partial sums of a split reduction (b*p2*na ~ 0.5 M rows at inv
    B0L1) add in fp32 too; on the CPU bf16 operands are widened."""
    if F2.dtype == torch.bfloat16 and F2.device.type == 'cuda':
        return torch.mm(F2.t(), dout2, out_dtype=torch.float32)
    return torch.mm(build.widen(F2).t(), build.widen(dout2))


class InterConvFn(torch.autograd.Function):
    """The W-fused inter conv with its hand-written backward (the
    ``fused_gather_conv_w`` custom VJP). Gradients flow to the table and W
    only: gx, idx, rk, k2 and sigma get none, as the JAX VJP zeroes them.

    The backward takes ``_fgcw_bwd``'s two routes, in either dtype: the
    fused dTable / dW kernels, or, where ``composed_backward`` holds, its
    composition (``_fgcw_bwd:1685-1703``): dF = dout W^T in the table's
    type, dT by the W-off scatter (fp32 sums, rounded to the table's type
    once), F recomputed by the W-off forward in the table's type (not saved
    from the forward, as in the JAX package) and dW = F^T dout summed in
    fp32 (``dw_product``) and rounded to W's type."""

    @staticmethod
    def forward(ctx, gx, idx, table, rk, k2, W, sigma):
        ctx.save_for_backward(gx, idx, table, rk, k2, W)
        ctx.sigma = sigma
        return inter_conv(gx, idx, table, rk, k2, W, sigma)

    @staticmethod
    def backward(ctx, dout):
        gx, idx, table, rk, k2, W = ctx.saved_tensors
        dout = dout.contiguous()
        q, sigma = table.shape[1], ctx.sigma
        K, c, d = W.shape
        composed = composed_backward(c, idx.shape[2])
        dT = dW = None
        if ctx.needs_input_grad[2]:
            if composed:
                dF = torch.matmul(dout.reshape(-1, d),
                                  W.reshape(K * c, d).t())
                dT = inter_conv_dg(gx, idx, q, rk, k2,
                                   dF.reshape(dout.shape[:3] + (K, c)), sigma)
                del dF
            else:
                dT = inter_conv_dtable(gx, idx, q, rk, k2, W, dout, sigma)
            dT = dT.to(table.dtype)
        if ctx.needs_input_grad[5]:
            if composed:
                F = inter_conv_f(gx, idx, table, rk, k2, sigma)
                dW = dw_product(F.reshape(-1, K * c), dout.reshape(-1, d))
                dW = dW.reshape(K, c, d).to(W.dtype)
            else:
                dW = inter_conv_dw(gx, idx, table, rk, k2, dout, sigma)
        return None, None, dT, None, None, dW, None
