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

The forward also runs in bf16 (f, W and out bf16, products and sums fp32),
and in the PRENORM form of the production mode, which replaces
``intra_conv_prenorm`` (``_fwd_pallas`` -> ``_kernel_prenorm``): the
preceding inter conv's deferred norm and activation applied on load,

  out = intra_conv(z, W),  z = act(f * scale + shift) rounded to f's type,

with ss = [scale; shift] fp32 lanes [1 or b, 2, na*c] and act the leaky ReLU
of a slope with mask ``u > 0`` (``build.leaky``): 0.01 for the leaky ReLU, 0
for the ReLU (``build.ACT_SLOPES``), a launch argument of the kernels. Its backward replaces ``_prenorm_bwd`` -> ``_bwd_pallas``
-> ``_bwd_kernel_prenorm`` (``IntraConvPrenormFn``): with u = f * scale +
shift and dz the df above, never rounded,

  du = dz * act'(u),  df = du * scale,  dscale = sum_p du * f,
  dshift = sum_p du,  dW = the dW above on z,

the per-lane sums over the points (and over the clouds when ss has batch 1).
Every kernel here takes fp32 and bf16 operands; products and sums are fp32.

The bf16 forward (plain and prenorm) and the bf16 B6 df run on tensor cores
(``intra_conv_mma_kernel``, picked by ``mma_route``: every layer of both
models) at the rounding points of the SGEMM and the plain versions: z
rounded to bf16 after the fold and the activation, fp32 sums, the output
rounded once (df: dz never rounded, df rounded once). So does the bf16 dW,
plain and prenorm (``intra_dw_mma_kernel``, picked by ``dw_mma_route``): z
rounded to bf16, fp32 sums, dW fp32. The fp32 dW of the plain form runs
on the CUDA cores in a kernel of its own (``intra_dw_f32_kernel``, picked
by ``dw_f32_route``: every model layer), FFMA only, fp32 sums; so does the
fp32 forward of the plain form and its df (``intra_fwd_f32_kernel``, picked
by ``fwd_f32_route``: every model layer). The other shapes, and the fp32
prenorm forms, run the register-blocked SGEMM (``intra_conv_kernel``;
``intra_dw_kernel`` for dW).
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
    'intra_conv_prenorm': ('intra_conv_prenorm_plain', SOURCE,
                           'epn_pointcloud_tpu/ops/pallas/intra_conv.py:81'),
    'intra_conv_prenorm_df': ('intra_conv_prenorm_df_plain', SOURCE,
                              'epn_pointcloud_tpu/ops/pallas/intra_conv.py'
                              ':205'),
    'intra_conv_prenorm_dw': ('intra_conv_prenorm_dw_plain', SOURCE,
                              'epn_pointcloud_tpu/ops/pallas/intra_conv.py'
                              ':205'),
}
# rows of a block of the SGEMM prenorm df kernel: it owns 128 // na whole
# points
_DF_BLOCK_ROWS = 128
launches = dict.fromkeys(ENTRIES, 0)
# the launches of the forward product (intra_conv, intra_conv_prenorm, and
# the df of intra_conv_prenorm_df) by kernel: 'mma', the bf16 tensor-core
# kernel (``intra_conv_mma_kernel``), 'fwd_f32', the fp32 CUDA-core kernel
# (``intra_fwd_f32_kernel``), or 'sgemm', the register-blocked SGEMM;
# of dW (intra_conv_dw, intra_conv_prenorm_dw): 'dw_mma', the bf16
# tensor-core kernel (``intra_dw_mma_kernel``), 'dw_f32', the fp32
# CUDA-core kernel (``intra_dw_f32_kernel``), or 'dw', the SGEMM
# (``intra_dw_kernel``)
routes = dict.fromkeys(('mma', 'fwd_f32', 'sgemm', 'dw_mma', 'dw_f32', 'dw'),
                       0)
# the tensor-core kernels' shapes (``mma_route``, ``dw_mma_route``): the
# icosahedral group's anchors and kernel points, and the widths of the
# models' intra layers
MMA_NA, MMA_K, MMA_WIDTHS = 60, 12, (32, 64, 128, 256)
# the tensor-core dW's blocks: whole groups of DW_MMA_NP points, DW_MMA_CB
# channels and 64 columns (32 where d % 64 != 0); its row splits fill at
# most DW_MMA_BLOCKS blocks (one an SM: two waves of the 132 SMs)
DW_MMA_NP, DW_MMA_CB, DW_MMA_BLOCKS = 8, 32, 264
# the fp32 CUDA-core dW's blocks: DW_F32_CB channels of all 12 kernel
# points by DW_F32_BN columns, whole points a split, three blocks an SM:
# DW_F32_WAVE blocks fill the 132 SMs once; its splits fill one or two
# such waves
DW_F32_CB, DW_F32_BN, DW_F32_WAVE = 32, 32, 396
# a split's sums add its rows in one chain of fmaf: past DW_F32_MAX_PTS
# points a split (the longest chain of the cls and inv layers) two waves
# are taken, for chains half as long (reg_so3net's 256-wide layer at 64
# points: 171 points a split put its float64 error at 1.59x the SGEMM's)
DW_F32_MAX_PTS = 128
# the fp32 CUDA-core forward's envelope: c and d multiples of FWD_F32_MULT
# (whole 8-channel chunks, whole 32-column tiles; kMult in the source)
FWD_F32_MULT = 32


def mma_route(dtype, na: int, K: int, c: int, d: int) -> bool:
    """Whether a forward or B6 df runs the bf16 tensor-core kernel: bf16
    operands, na == 60, K == 12 and c == d in MMA_WIDTHS (every intra layer
    of both models). fp32 runs the CUDA-core kernel where ``fwd_f32_route``
    holds; the other shapes run the SGEMM."""
    return (dtype == torch.bfloat16 and na == MMA_NA and K == MMA_K
            and c == d and c in MMA_WIDTHS)


def dw_mma_route(dtype, na: int, K: int, c: int, d: int) -> bool:
    """Whether a dW (plain or prenorm) runs the bf16 tensor-core kernel
    (``intra_dw_mma_kernel``): the forward's envelope, bf16 operands, na ==
    60, K == 12 and c == d in MMA_WIDTHS (every intra layer of both models).
    fp32 and the other shapes run the SGEMM (``intra_dw_kernel``)."""
    return mma_route(dtype, na, K, c, d)


def dw_f32_route(dtype, na: int, K: int, c: int, d: int,
                 prenorm: bool = False) -> bool:
    """Whether a dW runs the fp32 CUDA-core kernel
    (``intra_dw_f32_kernel``): fp32 operands, the plain form (no prenorm
    fold), na == 60, K == 12, c % 32 == 0 and d % 32 == 0 (every intra
    layer of both models in fp32). The prenorm form and the other shapes
    run the SGEMM (``intra_dw_kernel``)."""
    return (dtype == torch.float32 and not prenorm and na == MMA_NA
            and K == MMA_K and c % DW_F32_CB == 0 and d % DW_F32_BN == 0)


def fwd_f32_route(dtype, na: int, K: int, c: int, d: int,
                  prenorm: bool = False) -> bool:
    """Whether a forward (or the plain form's df, the forward on the inverse
    adjacency) runs the fp32 CUDA-core kernel (``intra_fwd_f32_kernel``):
    fp32 operands, the plain form (no prenorm fold), na == 60, K == 12, c
    and d multiples of FWD_F32_MULT (every intra layer of both models in
    fp32). The prenorm form and the other shapes run the SGEMM
    (``intra_conv_kernel``)."""
    return (dtype == torch.float32 and not prenorm and na == MMA_NA
            and K == MMA_K and c % FWD_F32_MULT == 0
            and d % FWD_F32_MULT == 0)


def dw_f32_splits(n_points: int, na: int, c: int, d: int) -> tuple[int, int]:
    """(splits, rows a split) of an fp32 CUDA-core dW call over n_points
    = b * p points of na rows: whole points a split (every split holds at
    least one), blocks of DW_F32_CB channels by DW_F32_BN columns, in one
    or two waves of DW_F32_WAVE blocks, whichever leaves the fewer points
    a wave's blocks (two on a tie: shorter sums, and a wave's few idle
    slots either way), and two where one wave's splits would hold more
    than DW_F32_MAX_PTS points."""
    tiles = (c // DW_F32_CB) * (d // DW_F32_BN)
    best = None
    for waves in (1, 2):
        per = -(-n_points // max(1, waves * DW_F32_WAVE // tiles))
        if (best is None or waves * per <= best[0] * best[1]
                or best[1] > DW_F32_MAX_PTS):
            best = (waves, per)
    per = best[1]
    return -(-n_points // per), per * na


def dw_splits(n_points: int, na: int, K: int, c: int, d: int,
              mma: bool) -> tuple[int, int]:
    """(splits, rows a split) of a dW call over n_points = b * p points of na
    rows: each split writes a partial dW [K, c, d] to the workspace. The
    tensor-core kernel's splits are whole groups of DW_MMA_NP points (every
    split holds at least one), at most DW_MMA_BLOCKS blocks of DW_MMA_CB
    channels and 64 (or 32) columns: rounded down, as a third wave of a
    few blocks would take as long as a full one (the 256-wide layers: 8
    splits of 32 blocks, not 9); the SGEMM's are 16-row slices, aimed at ~4
    blocks an SM of 128 (k, c) rows and 128, 64 or 32 columns."""
    if mma:
        groups = -(-n_points // DW_MMA_NP)
        tiles = (c // DW_MMA_CB) * (d // (64 if d % 64 == 0 else 32))
        s = max(1, min(groups, DW_MMA_BLOCKS // tiles))
        per = -(-groups // s)
        return -(-groups // per), per * DW_MMA_NP * na
    slices = -(-n_points * na // 16)
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    s = build.n_splits(-(-K * c // 128) * (d // bn), slices)
    return s, -(-slices // s) * 16


def mma_block_points(d: int) -> int:
    """Points a block of the tensor-core kernel owns at d output columns:
    512 / BN with BN = 128, 64 or 32 the columns it owns (csrc
    ``mma::block_points``)."""
    return 512 // (128 if d % 128 == 0 else 64 if d % 64 == 0 else 32)


def intra_conv_plain(f: torch.Tensor, trace_idx: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    """f [b, p, na, c], trace_idx [na, K] int, W [K, c, d] -> [b, p, na, d]
    (fp32 arithmetic, rounded to f's type)."""
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    g = build.widen(f)[:, :, trace_idx.long()]            # [b, p, na, K, c]
    out = g.reshape(-1, K * c) @ build.widen(W).reshape(K * c, d)
    return out.reshape(b, p, na, d).to(f.dtype)


def prenorm_plain(f: torch.Tensor, ss: torch.Tensor,
                  slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """z = act(f * ss[:, 0] + ss[:, 1]) per lane in fp32, rounded to f's
    type (f [b, p, na, c], ss [1 or b, 2, na*c]; act the leaky ReLU of
    ``slope``)."""
    b, p, na, c = f.shape
    u = build.widen(f).reshape(b, p, na * c) * ss[:, 0:1] + ss[:, 1:2]
    return build.leaky(u, slope).to(f.dtype).reshape(f.shape)


def intra_conv_prenorm_plain(f: torch.Tensor, ss: torch.Tensor,
                             trace_idx: torch.Tensor, W: torch.Tensor,
                             slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """The intra conv of the deferred-norm activation prenorm(f, ss)."""
    return intra_conv_plain(prenorm_plain(f, ss, slope), trace_idx, W)


def intra_conv_df_plain(dout: torch.Tensor, trace_idx: torch.Tensor,
                        W: torch.Tensor) -> torch.Tensor:
    """df [b, p, na, c] (fp32 from bf16 operands): each (a, k) term dout[a]
    W[k]^T added onto input anchor trace_idx[a, k] (a scatter; no use of the
    inverse adjacency)."""
    dout, W = build.widen(dout), build.widen(W)
    b, p, na, _ = dout.shape
    K, c = W.shape[0], W.shape[1]
    g = torch.einsum('bpad,kcd->bpakc', dout, W).reshape(b, p, na * K, c)
    df = dout.new_zeros(b, p, na, c)
    return df.index_add(2, trace_idx.reshape(-1).long(), g)


def intra_conv_dw_plain(f: torch.Tensor, trace_idx: torch.Tensor,
                        dout: torch.Tensor) -> torch.Tensor:
    """dW [K, c, d] = sum over (b, p, a) of the gathered f^T dout (fp32 from
    bf16 operands)."""
    g = build.widen(f)[:, :, trace_idx.long()]            # [b, p, na, K, c]
    return torch.einsum('bpakc,bpad->kcd', g, build.widen(dout))


def intra_conv_prenorm_df_plain(dout: torch.Tensor, f: torch.Tensor,
                                ss: torch.Tensor, trace_idx: torch.Tensor,
                                W: torch.Tensor,
                                slope: float = build.LEAKY_SLOPE):
    """(df [b, p, na, c] in f's type, dss fp32 like ss) of the prenorm conv,
    from the formula: dz the scatter df in fp32, never rounded; du = dz *
    act'(u) with u = f * scale + shift and the mask u > 0 (slope ``slope``
    below it); df = du * scale;
    dscale = sum_p du * f and dshift = sum_p du per lane, over the clouds
    too when ss has batch 1."""
    b, p, na, c = f.shape
    dz = intra_conv_df_plain(dout, trace_idx, W).reshape(b, p, na * c)
    fw = build.widen(f).reshape(b, p, na * c)
    u = fw * ss[:, 0:1] + ss[:, 1:2]
    du = torch.where(u > 0, dz, slope * dz)
    df = (du * ss[:, 0:1]).to(f.dtype).reshape(f.shape)
    dss = torch.stack([(du * fw).sum(1), du.sum(1)], dim=1)   # [b, 2, L]
    if ss.shape[0] == 1:
        dss = dss.sum(0, keepdim=True)
    return df, dss


def intra_conv_prenorm_dw_plain(f: torch.Tensor, ss: torch.Tensor,
                                trace_idx: torch.Tensor, dout: torch.Tensor,
                                slope: float = build.LEAKY_SLOPE
                                ) -> torch.Tensor:
    """dW [K, c, d] of the prenorm conv: the dW of z = prenorm(f, ss)."""
    return intra_conv_dw_plain(prenorm_plain(f, ss, slope), trace_idx, dout)


def _want_ss(kernel, want, ss, b, L):
    """Adds the fold ss [1 or b, 2, L] fp32 (if given) to the operands to
    check; returns its batch (0 without one)."""
    if ss is None:
        return 0
    sb = ss.shape[0]
    if sb not in (1, b):
        raise ValueError(f'{kernel}: ss needs a batch of 1 or {b}, got {sb}')
    want['ss'] = (ss, torch.float32, (sb, 2, L))
    return sb


def _check_operands(kernel, dev, want):
    """The wrappers' card branch: a CUDA device, and each operand as
    ``build.check_operands`` wants it."""
    if dev.type != 'cuda':
        raise ValueError(f'{kernel}: unsupported device {dev}')
    build.check_operands(kernel, dev, want)


def _check_shape(kernel, b, p, na, K, c, d):
    if c % 4 != 0 or d % 32 != 0 or na * K > 1024 or b * p * na >= 2 ** 31:
        raise ValueError(f'{kernel}: kernel needs c % 4 == 0, d % 32 == 0, '
                         f'na*K <= 1024 and b*p*na < 2^31; got b={b} p={p} '
                         f'na={na} K={K} c={c} d={d}')


def _launch_fwd(kernel, f, trace_idx, W, ss, slope=build.LEAKY_SLOPE):
    """Checks and launches the forward kernel (ss None: no prenorm; slope
    the prenorm activation's)."""
    dev = f.device
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    bf16 = build.dtype_flag(f.dtype, kernel)
    want = {'f': (f, f.dtype, (b, p, na, c)),
            'trace_idx': (trace_idx, torch.int32, (na, K)),
            'W': (W, f.dtype, (K, c, d))}
    sb = _want_ss(kernel, want, ss, b, na * c)
    _check_operands(kernel, dev, want)
    _check_shape(kernel, b, p, na, K, c, d)
    out = torch.empty((b, p, na, d), dtype=f.dtype, device=dev)
    ptrs = (f.data_ptr(), trace_idx.data_ptr(), W.data_ptr(),
            0 if ss is None else ss.data_ptr(), out.data_ptr(), b, p, na, K,
            c, d, 2 * na * c if sb > 1 else 0)
    launches[kernel] += 1
    mma = mma_route(f.dtype, na, K, c, d)
    if mma or fwd_f32_route(f.dtype, na, K, c, d, ss is not None):
        routes['mma' if mma else 'fwd_f32'] += 1
        build.launch(*(('epn_intra_conv_mma', *ptrs, slope) if mma else
                       ('epn_intra_conv_f32', *ptrs)), build.stream(f))
    else:
        routes['sgemm'] += 1
        build.launch('epn_intra_conv', *ptrs, slope, bf16, build.stream(f))
    return out


def intra_conv(f: torch.Tensor, trace_idx: torch.Tensor,
               W: torch.Tensor) -> torch.Tensor:
    """Forward kernel wrapper: plain version on the CPU, CUDA kernel on the
    card (the tensor-core kernel where ``mma_route`` holds, the fp32
    CUDA-core kernel where ``fwd_f32_route`` does, else the SGEMM)."""
    if f.device.type == 'cpu':
        return intra_conv_plain(f, trace_idx, W)
    return _launch_fwd('intra_conv', f, trace_idx, W, None)


def intra_conv_prenorm(f: torch.Tensor, ss: torch.Tensor,
                       trace_idx: torch.Tensor, W: torch.Tensor,
                       slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """PRENORM forward kernel wrapper (act the leaky ReLU of ``slope``):
    plain version on the CPU, CUDA kernel on the card (the tensor-core
    kernel where ``mma_route`` holds, else the SGEMM). Both are
    deterministic (no atomics)."""
    if f.device.type == 'cpu':
        return intra_conv_prenorm_plain(f, ss, trace_idx, W, slope)
    return _launch_fwd('intra_conv_prenorm', f, trace_idx, W, ss, slope)


def intra_conv_df(dout: torch.Tensor, trace_idx: torch.Tensor,
                  inv_idx: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """df wrapper -> df in dout's type (bf16 rounded once from its fp32
    sums, as the TPU kernel stores df in f's type): the plain scatter on the
    CPU; on the card the forward kernel on (dout, inv_idx, W transposed to
    [K, d, c]), on its route."""
    if dout.device.type == 'cpu':
        return intra_conv_df_plain(dout, trace_idx, W).to(dout.dtype)
    return intra_conv(dout, inv_idx, W.transpose(1, 2).contiguous())


def _launch_dw(kernel, f, trace_idx, dout, ss, slope=build.LEAKY_SLOPE):
    """Checks and launches the dW kernel (ss None: no prenorm; slope the
    prenorm activation's): the
    tensor-core kernel where ``dw_mma_route`` holds, the fp32 CUDA-core
    kernel where ``dw_f32_route`` does, else the SGEMM; each sums
    per-row-range partials in a fixed order: deterministic."""
    dev = f.device
    b, p, na, c = f.shape
    K, d = trace_idx.shape[1], dout.shape[-1]
    bf16 = build.dtype_flag(f.dtype, kernel)
    want = {'f': (f, f.dtype, (b, p, na, c)),
            'trace_idx': (trace_idx, torch.int32, (na, K)),
            'dout': (dout, f.dtype, (b, p, na, d))}
    sb = _want_ss(kernel, want, ss, b, na * c)
    _check_operands(kernel, dev, want)
    _check_shape(kernel, b, p, na, K, c, d)
    mma = dw_mma_route(f.dtype, na, K, c, d)
    f32 = dw_f32_route(f.dtype, na, K, c, d, ss is not None)
    splits, rows = (dw_f32_splits(b * p, na, c, d) if f32 else
                    dw_splits(b * p, na, K, c, d, mma))
    ws = torch.empty((splits, K, c, d), dtype=torch.float32, device=dev)
    dW = torch.empty((K, c, d), dtype=torch.float32, device=dev)
    ptrs = (f.data_ptr(), trace_idx.data_ptr(),
            0 if ss is None else ss.data_ptr(), dout.data_ptr(),
            ws.data_ptr(), dW.data_ptr(), b, p, na, K, c, d,
            2 * na * c if sb > 1 else 0)
    launches[kernel] += 1
    if mma or f32:
        routes['dw_mma' if mma else 'dw_f32'] += 1
        build.launch(*(('epn_intra_conv_bwd_w_mma', *ptrs, slope) if mma else
                       ('epn_intra_conv_bwd_w_f32', *ptrs)), splits, rows,
                     build.stream(f))
    else:
        routes['dw'] += 1
        build.launch('epn_intra_conv_bwd_w', *ptrs, slope, splits, bf16,
                     build.stream(f))
    return dW


def intra_conv_dw(f: torch.Tensor, trace_idx: torch.Tensor,
                  dout: torch.Tensor) -> torch.Tensor:
    """dW kernel wrapper: plain version on the CPU, CUDA kernel on the
    card (the tensor-core kernel where ``dw_mma_route`` holds, the fp32
    CUDA-core kernel where ``dw_f32_route`` does, else the SGEMM)."""
    if f.device.type == 'cpu':
        return intra_conv_dw_plain(f, trace_idx, dout)
    return _launch_dw('intra_conv_dw', f, trace_idx, dout, None)


def intra_conv_prenorm_dw(f: torch.Tensor, ss: torch.Tensor,
                          trace_idx: torch.Tensor, dout: torch.Tensor,
                          slope: float = build.LEAKY_SLOPE) -> torch.Tensor:
    """B6 dW wrapper (z = prenorm(f, ss) formed from f on the card, act the
    leaky ReLU of ``slope``): plain version on the CPU, CUDA kernel on the
    card (the tensor-core kernel where ``dw_mma_route`` holds, else the
    SGEMM)."""
    if f.device.type == 'cpu':
        return intra_conv_prenorm_dw_plain(f, ss, trace_idx, dout, slope)
    return _launch_dw('intra_conv_prenorm_dw', f, trace_idx, dout, ss, slope)


def intra_conv_prenorm_df(dout: torch.Tensor, f: torch.Tensor,
                          ss: torch.Tensor, trace_idx: torch.Tensor,
                          inv_idx: torch.Tensor, W: torch.Tensor,
                          slope: float = build.LEAKY_SLOPE):
    """B6 df wrapper -> (df, dss) (the forward's act the leaky ReLU of
    ``slope``): the plain version on the CPU; on the card the forward's
    product on (dout, inv_idx, W transposed to [K, d, c]) with the prenorm
    epilogue (on tensor cores where ``mma_route`` holds), dss from
    per-block partials summed in a fixed order (deterministic)."""
    if f.device.type == 'cpu':
        return intra_conv_prenorm_df_plain(dout, f, ss, trace_idx, W, slope)
    kernel = 'intra_conv_prenorm_df'
    dev = f.device
    b, p, na, c = f.shape
    K, d = W.shape[0], W.shape[2]
    bf16 = build.dtype_flag(f.dtype, kernel)
    Wt = W.transpose(1, 2).contiguous()
    want = {'dout': (dout, f.dtype, (b, p, na, d)),
            'f': (f, f.dtype, (b, p, na, c)),
            'inv_idx': (inv_idx, torch.int32, (na, K)),
            'W': (Wt, f.dtype, (K, d, c))}
    sb = _want_ss(kernel, want, ss, b, na * c)
    _check_operands(kernel, dev, want)
    _check_shape(kernel, b, p, na, K, d, c)
    if na > 64:
        raise ValueError(f'{kernel}: kernel needs na <= 64; got na={na}')
    mma = mma_route(f.dtype, na, K, c, d)
    n_blocks = -(-p // (mma_block_points(c) if mma else
                        _DF_BLOCK_ROWS // na))
    ws = torch.empty((2, n_blocks, b, na * c), dtype=torch.float32,
                     device=dev)
    df = torch.empty((b, p, na, c), dtype=f.dtype, device=dev)
    dscale = torch.empty((sb, na * c), dtype=torch.float32, device=dev)
    dshift = torch.empty((sb, na * c), dtype=torch.float32, device=dev)
    ptrs = (dout.data_ptr(), inv_idx.data_ptr(), Wt.data_ptr(), f.data_ptr(),
            ss.data_ptr(), df.data_ptr(), ws.data_ptr(), dscale.data_ptr(),
            dshift.data_ptr(), b, p, na, K, d, c, sb, slope)
    launches[kernel] += 1
    if mma:
        routes['mma'] += 1
        build.launch('epn_intra_conv_prenorm_df_mma', *ptrs, build.stream(f))
    else:
        routes['sgemm'] += 1
        build.launch('epn_intra_conv_prenorm_df', *ptrs, bf16,
                     build.stream(f))
    return df, torch.stack([dscale, dshift], dim=1)


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


class IntraConvPrenormFn(torch.autograd.Function):
    """The prenorm intra conv with its hand-written backward (the
    ``intra_conv_prenorm`` custom VJP, ``_bwd_kernel_prenorm``): gradients to
    f, the fold ss and W; ``slope`` the activation's (``build.ACT_SLOPES``),
    no gradient, handed to each wrapper as its last argument."""

    @staticmethod
    def forward(ctx, f, ss, trace_idx, inv_idx, W, slope=build.LEAKY_SLOPE):
        ctx.save_for_backward(f, ss, trace_idx, inv_idx, W)
        ctx.slope = slope
        return intra_conv_prenorm(f, ss, trace_idx, W, slope)

    @staticmethod
    def backward(ctx, dout):
        f, ss, trace_idx, inv_idx, W = ctx.saved_tensors
        dout = dout.contiguous()
        df = dss = dW = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            df, dss = intra_conv_prenorm_df(dout, f, ss, trace_idx, inv_idx,
                                            W, ctx.slope)
        if ctx.needs_input_grad[4]:
            dW = intra_conv_prenorm_dw(f, ss, trace_idx, dout, ctx.slope)
        return df, dss, None, None, dW, None
