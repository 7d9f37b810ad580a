"""Where the bf16 tensor-core intra conv (``intra_conv_mma_kernel`` in
csrc/intra_conv.cu: B5, the prenorm forward, and B6 df; and
``intra_dw_mma_kernel``: B6 dW) spends its time, on the card: each kernel
as built beside variants with one part changed or taken out, at the shapes
of both models' layers, with the same timer (``chip_smoke.time_ms``).

  python -m epn_pointcloud_tpu_torch.intra_conv_variants

It imports ``chip_smoke`` from the repository root. Each variant is
csrc/intra_conv.cu compiled alone (nvcc, sm_90a) under
build/intra_conv_variants/ with one text substitution (which fails loudly
when the source no longer holds the text):
  built          the source as it is (a fresh accumulator every kGroup = 2
                 k16 steps);
  group_1        a fresh accumulator every k16 step;
  group_4        a fresh accumulator every four k16 steps (a W slice);
  in_place       every mma accumulates into the running sum (the
                 truncating accumulation: its outputs lean toward zero);
  no_gather      the A rows read without the adjacency (slab row = the
                 output row): the gather's bank conflicts' share; wrong;
  no_mma         no mma issued (staging, fragment loads, W stream and
                 epilogue still run); wrong;
  no_w_loads     no W slice loaded (the products run on stale shared
                 memory): the W stream's share; wrong.
The forward is timed in its prenorm form and, built only, in its plain
form (``no_fold``: the same kernel staging the slab by cp.async, without
the fold); df at the step's batch. For the variants that keep the
arithmetic, the normwise error against the plain version and the share of
outputs that rounded toward zero less the share that rounded away from
it (``lean``). Operands are random (seeded) at the shapes of
cls_so3net_pn (forward b=32, df b=12, one fold for the batch) and
inv_so3net_pn (b=16 a leg, a fold a patch). The dW kernel's variants
(the step's batch, the fold as in df), whose output is wrong
and only whose time counts:
  dw_no_gather   the A rows read without the adjacency (slab row = the
                 reduction row): the gather's share;
  dw_no_mma      the product issues no mma (the fragment loads, the fresh
                 accumulators' adds, the staging and the barriers run);
and beside them, from the built library, B6 dW without its fold
(``dw_no_fold``: the plain form, the same kernel with no fold pass; right
for the plain form) and the SGEMM (``intra_dw_kernel``, bf16, the route
before the tensor-core kernel), and the built kernel's and the SGEMM's
normwise error against ``intra_conv_prenorm_dw_plain``.

The fp32 dW of the plain form on the CUDA cores (``intra_dw_f32_kernel``,
epn_intra_conv_bwd_w_f32) at the same layers and batches, beside the
SGEMM (``intra_dw_kernel`` in fp32, ``sgemm``, from the built library):
  f32_built      the source as it is (a three-stage ring);
  f32_ring_1     each point's loads waited for before its product, so no
                 load is in flight behind the FFMA (what a one-stage ring
                 does);
  f32_kq_lanes   the lanes of a quarter-warp share a kernel-point triple
                 and the warps own column octets (the source: the warps
                 own the triples, the quarter-warps the column octets), so
                 every dout load is warp-uniform and each f load reads
                 four different slab rows;
  f32_packed_offsets
                 each anchor's three slab rows of the warp's kernel points
                 packed into one word (a 4-byte offsets load a row, and a
                 mask and a multiply a kernel point);
  f32_kt2        two kernel points a thread (2 x 4 x 8 = 64 sums; 6 warps a
                 block, 18 warps an SM at <= 112 registers);
  f32_unroll_u   the row loop unrolled by u = 2, 4, 6, 10 or 20 (the
                 source: by 12);
and, whose output is wrong and only whose time counts:
  f32_no_ffma    the product cut to 3 FFMA and 16 FADD a row that read
                 every loaded value (the staging, the offset loads and
                 the shared loads still run);
  f32_no_gather  the f rows read without the adjacency (slab row = the
                 reduction row).
Each build, the SGEMM too, is timed in turn and then in the reverse order,
and the two times averaged; for the SGEMM and the builds whose output is
right the normwise error against ``intra_conv_dw_plain``; for each build its
kernel's registers and spills (nvcc's -Xptxas -v).

The fp32 forward of the plain form on the CUDA cores
(``intra_fwd_f32_kernel``, epn_intra_conv_f32; the df is the same kernel on
the inverse adjacency and W^T) beside the SGEMM (``intra_conv_kernel`` in
fp32, epn_intra_conv, ``fwd_sgemm``, from the built library), at the cls
layers at b=32 (the serving forward) and b=12 (the train step's forward,
and its df on the inverse adjacency) and the inv layers at b=16 (a leg's
forward). The SGEMM by parts:
  fwd_sgemm_no_ffma   its product cut to 15 FADD a reduction step that read
                      every loaded value (the gathered loads, the stores,
                      the barriers still run); wrong;
  fwd_sgemm_no_gather the A rows read without the adjacency (a row reads
                      its own anchor's f row for every kernel point); wrong;
  fwd_sgemm_wait      the next slice's loads stored to shared memory, and a
                      barrier passed, before the slice's FFMA (no load in
                      flight behind the product);
the CUDA-core kernel's builds:
  fwdf_built          the source as it is (15 anchors x 8 columns a thread,
                      128 threads, a two-stage ring, the product stepping 4
                      channels, the kernel-point loop unrolled by 2);
  fwdf_no_ffma        its product cut to 92 FADD a 4-channel step (against
                      480 FFMA) that read every loaded value; wrong;
  fwdf_no_gather      the f rows read without the adjacency (slab row = the
                      output row); wrong;
  fwdf_wait           each chunk's loads waited for before its product
                      (what a one-stage ring does);
  fwdf_ring_3         a three-stage ring (two chunks in flight);
  fwdf_cs2, fwdf_cs1  the product stepping 2 or 1 channels: W held for 2
                      or 1 channels, f read by 8- or 4-byte loads; the same
                      sums in the same order;
  fwdf_at10, fwdf_at12, fwdf_at20_cs1
                      10 anchors a thread (192 threads), 12 (160), or 20
                      (96 threads, stepping 1 channel);
  fwdf_unroll_u       the kernel-point loop unrolled by u = 1, 3 or 4.
Each build, the SGEMM too, is timed in turn and then in the reverse order,
and the two times averaged; for the builds whose output is right the
normwise error against ``intra_conv_plain`` on the call's adjacency, and
for the SGEMM and the built kernel against it in float64; for each build
its kernels' registers and spills.

  python -m epn_pointcloud_tpu_torch.intra_conv_variants

One JSON line a shape, a sum over each model's layers, a line a build's
registers, all of them in chiprun_out/intra_conv_variants.json. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import numpy as np
import torch

from .ops import icosahedron
from .ops.kernels import build, intra_conv

OUT = os.path.join(build.BUILD_DIR, 'intra_conv_variants')
ROOT = os.path.dirname(build.BUILD_DIR)
_MMA = 'tc::mma(t[ni], af, bf[u][ni][0], bf[u][ni][1]);'
# the forward's kGroup (the dW kernel has its own)
_GROUP = 'constexpr int kGroup = 2;        // k16 steps summed'
# variant -> (text in the source, its replacement), or None for the source
VARIANTS = {
    'built': None,
    'group_1': (_GROUP, _GROUP.replace('= 2', '= 1')),
    'group_4': (_GROUP, _GROUP.replace('= 2', '= 4')),
    'in_place': (_MMA, 'tc::mma(acc[mi][ni], af, bf[u][ni][0], '
                 'bf[u][ni][1]);'),
    'no_gather': ('pt60[mi] + tk[u][anc[mi]]', 'pt60[mi] + anc[mi]'),
    'no_mma': (_MMA, 'if (C < 0) ' + _MMA),
    'no_w_loads': ('tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, BN / 8)),',
                   'if (C < 0) tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, '
                   'BN / 8)),'),
}
_DW_MMA = 'tc::mma(r4, af[mi][ks], bq[ks][2 * h2], bq[ks][2 * h2 + 1]);'
DW_VARIANTS = {
    'dw_no_gather': ('zs + tc::swz(p60[ks] + tk[anc[ks]], col,',
                     'zs + tc::swz(p60[ks] + anc[ks], col,'),
    'dw_no_mma': (_DW_MMA, 'if (C < 0) ' + _DW_MMA),
}
_FFMA = 'acc[j][i][q] = fmaf(xv[i], dv[q], acc[j][i][q]);'
_RING = 'load(g + kStages - 1);'
F32_VARIANTS = {
    'f32_built': None,
    'f32_ring_1': (_RING, _RING + ' tc::cp_wait<0>(); __syncthreads();'),
    'f32_no_ffma': (_FFMA, 'if (i == 0 && q == 0) acc[j][0][0] = fmaf((xv[0]'
                    ' + xv[1]) + (xv[2] + xv[3]), ((dv[0] + dv[1]) + (dv[2] '
                    '+ dv[3])) + ((dv[4] + dv[5]) + (dv[6] + dv[7])), '
                    'acc[j][0][0]);'),
    'f32_no_gather': ('o[j] = t[j] * kCB;', 'o[j] = a * kCB;'),
    'f32_kq_lanes': ('const int kg = warp, cq = lane & 7, co = lane >> 3;',
                     'const int kg = lane >> 3, cq = lane & 7, co = warp;'),
    'f32_packed_offsets': [
        ('s_off[i] = make_int4(o[0], o[1], o[2], o[3]);',
         'reinterpret_cast<int*>(s_off)[i] = o[0] / kCB | o[1] / kCB << 8 | '
         'o[2] / kCB << 16 | o[3] / kCB << 24;'),
        ('const int4 o = s_off[a * kWarps + kg];\n      const int oo[4] = '
         '{o.x, o.y, o.z, o.w};',
         'const int o = reinterpret_cast<const int*>(s_off)[a * kWarps + kg];'
         ' const int oo[4] = {(o & 255) * kCB, (o >> 8 & 255) * kCB, (o >> 16'
         ' & 255) * kCB, (o >> 24 & 255) * kCB};')],
    'f32_kt2': ('constexpr int kKT = 3;', 'constexpr int kKT = 2;'),
}
# the row loop unrolled by 2, 4, 6, 10 or 20 (the source: by 12)
_UNROLL = '#pragma unroll 12\n    for (int a = 0;'
F32_VARIANTS.update({f'f32_unroll_{u}': (_UNROLL,
                                          _UNROLL.replace('12', str(u)))
                     for u in (2, 4, 6, 10, 20)})
F32_EXACT = ('sgemm', 'f32_built', 'f32_ring_1', 'f32_kq_lanes',
             'f32_packed_offsets', 'f32_kt2', 'f32_unroll_2', 'f32_unroll_4',
             'f32_unroll_6', 'f32_unroll_10', 'f32_unroll_20')
EXACT = ('built', 'group_1', 'group_4', 'in_place')
# the SGEMM's FMA line; intra_dw_kernel holds it too, so fwd_sgemm_no_ffma
# cuts that kernel's product as well (only its forward is timed)
_SGEMM_FMA = ('for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], '
              'acc[i][j]);')
_SGEMM_LOAD = ('      load_slice<E, PRE, BN>(W, s_trace, a_pt, a_ss, '
               'a_anchor, (s + 1) * BK,\n'
               '                             tid, K, C, D, n0, L, slope, '
               'ra, rb);\n')
_SGEMM_STORE = ('    if (s + 1 < n_slices) store_slice<BN>(As[buf ^ 1], '
                'Bs[buf ^ 1], tid, ra, rb);\n')
_FWDF_FMA = 'acc[t][j] = fmaf(xv[i], w[i][j], acc[t][j]);'
_FWDF_UNROLL = '#pragma unroll 2\n    for (int k = 0;'
_FWDF_CS = 'constexpr int kCS = 4;'
_FWDF_RING = 'constexpr int kStages = 2;               // channel'
_FWDF_AT = 'constexpr int kAT = 15;'
# the fp32 forward's builds: the SGEMM by parts, then the CUDA-core kernel's
FWD_F32_VARIANTS = {
    'fwd_sgemm_no_ffma': (_SGEMM_FMA, 'for (int j = 0; j < TN; ++j) { if '
                          '(i == 0) acc[0][j] += b[j]; if (j == 0) acc[i][0] '
                          '+= a[i]; }'),
    'fwd_sgemm_no_gather': ('const int lane = s_trace[a_anchor[i] * K + k] '
                            '* C + c;', 'const int lane = a_anchor[i] * C + '
                            'c;'),
    'fwd_sgemm_wait': [(_SGEMM_LOAD, _SGEMM_LOAD + '      store_slice<BN>(As['
                        'buf ^ 1], Bs[buf ^ 1], tid, ra, rb);\n      '
                        '__syncthreads();\n'), (_SGEMM_STORE, '')],
    'fwdf_built': None,
    'fwdf_no_ffma': (_FWDF_FMA, '{ if (t == 0) acc[i][j] += w[i][j]; if (j '
                     '== 0) acc[t][i] += xv[i]; }'),
    'fwdf_no_gather': ('s_off[i] = t < kAT ? trace[(g * kAT + t) * kK + k] * '
                       'kCC : 0;', 's_off[i] = t < kAT ? (g * kAT + t) * kCC '
                       ': 0;'),
    'fwdf_wait': ('    load(ch + kStages - 1);\n', '    load(ch + kStages - '
                  '1);\n    tc::cp_wait<0>();\n    __syncthreads();\n'),
    'fwdf_ring_3': (_FWDF_RING, _FWDF_RING.replace('2', '3')),
    'fwdf_cs2': (_FWDF_CS, _FWDF_CS.replace('4', '2')),
    'fwdf_cs1': (_FWDF_CS, _FWDF_CS.replace('4', '1')),
}
# anchors a thread: 10 (v1's layout: 192 threads), 12 (160) or 20 (96,
# stepping 1 channel); the source: 15 (128 threads)
FWD_F32_VARIANTS.update({f'fwdf_at{a}': (_FWDF_AT, _FWDF_AT.replace(
    '15', str(a))) for a in (10, 12)})
FWD_F32_VARIANTS['fwdf_at20_cs1'] = [(_FWDF_AT, _FWDF_AT.replace('15', '20')),
                                     (_FWDF_CS, _FWDF_CS.replace('4', '1'))]
FWD_F32_VARIANTS.update({
    f'fwdf_unroll_{u}': (_FWDF_UNROLL, _FWDF_UNROLL.replace('2', str(u)))
    for u in (1, 3, 4)})
# the builds whose forward is right (the SGEMM from the built library)
FWD_F32_EXACT = ('fwd_sgemm', 'fwd_sgemm_wait', 'fwdf_built', 'fwdf_wait',
                 'fwdf_ring_3', 'fwdf_cs2', 'fwdf_cs1', 'fwdf_at10',
                 'fwdf_at12', 'fwdf_at20_cs1', 'fwdf_unroll_1',
                 'fwdf_unroll_3', 'fwdf_unroll_4')
# model -> [(call, batch, adjacency)]: the fp32 forward's timed calls
FWD_F32_CALLS = {'cls_so3net_pn': [('forward', 32, 'trace'),
                                   ('forward', 12, 'trace'),
                                   ('df', 12, 'inv')],
                 'inv_so3net_pn': [('forward', 16, 'trace')]}
# model -> (forward batch, df batch, fold a cloud, [(layer, p, c)])
SHAPES = {
    'cls_so3net_pn': (32, 12, False, [
        ('L0', 512, 64), ('L1', 512, 64), ('L2', 256, 128), ('L3', 256, 128),
        ('L4', 128, 256), ('L5', 128, 256), ('L6', 64, 256)]),
    'inv_so3net_pn': (16, 16, True, [
        ('B0L0', 512, 32), ('B0L1', 512, 32), ('B1L0', 256, 64),
        ('B1L1', 256, 64), ('B2L0', 128, 128), ('B2L1', 128, 128),
        ('B3L0', 64, 128), ('B3L1', 64, 128)]),
}


def _lean(got, want):
    """Share of elements rounded toward zero less the share rounded away
    from it, against ``want``."""
    d = (got.float() - want.float()) * torch.sign(want.float())
    return float(((d < 0).sum() - (d > 0).sum()) / d.numel())


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


ENTRIES = ('epn_intra_conv_mma', 'epn_intra_conv_prenorm_df_mma',
           'epn_intra_conv_bwd_w_mma', 'epn_intra_conv_bwd_w',
           'epn_intra_conv_bwd_w_f32', 'epn_intra_conv', 'epn_intra_conv_f32')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('intra_conv_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from .inter_bwd_variants import ptxas_usage
    variants = {**VARIANTS, **DW_VARIANTS, **F32_VARIANTS, **FWD_F32_VARIANTS}
    procs = {n: build.compile_alone(build.CSRC_DIR, 'intra_conv.cu',
                                    os.path.join(OUT, n), sub)
             for n, sub in variants.items()}
    fns, regs, failed = {}, {}, {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            failed[n] = log
            continue
        if n in F32_VARIANTS:
            regs[n] = ptxas_usage(log, 'intra_dw_f32_kernel')
        if n in FWD_F32_VARIANTS or n == 'built':
            regs[n] = {**regs.get(n, {}),
                       **ptxas_usage(log, 'intra_fwd_f32_kernel'),
                       **ptxas_usage(log, 'intra_conv_kernel')}
        lib = ctypes.CDLL(so)
        fns[n] = {}
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[n][entry] = fn
    if failed:
        raise RuntimeError('nvcc failed on ' + ''.join(
            f'{n}:\n{log}\n' for n, log in failed.items()))
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    stream = torch.cuda.current_stream().cuda_stream
    ti = torch.from_numpy(icosahedron.get_intra_idx()).to(dev)
    lines = (_fwd({n: fn for n, fn in fns.items() if n in VARIANTS}, dev,
                  card, stream, ti, time_ms)
             + _dw(fns, dev, card, stream, ti, time_ms)
             + _dw_f32(fns, dev, card, stream, ti, time_ms)
             + _fwd_f32(fns, dev, card, stream, time_ms))
    for n, use in regs.items():
        for fn_name, u in use.items():
            lines.append({'build': n, 'function': fn_name, **u})
            print(json.dumps(lines[-1]), flush=True)
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'intra_conv_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


def _fwd(fns, dev, card, stream, ti, time_ms):
    """The forward's and df's variants at each layer: JSON lines."""
    inv = torch.from_numpy(icosahedron.get_intra_inv_idx()).to(dev)
    lines = []

    def call(fn, args):
        def run():
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f'intra_conv_mma: CUDA error {err}')
        return run
    for model, (bf, bd, per_cloud, layers) in SHAPES.items():
        total = {}
        for tag, p, c in layers:
            rng = np.random.RandomState(p + c)
            rec = {}
            for part, b in (('forward', bf), ('df', bd)):
                def rand(*shape, scale=1.0):
                    return torch.from_numpy((scale * rng.randn(*shape)).astype(
                        np.float32)).to(dev)
                f = rand(b, p, 60, c).bfloat16()
                W = rand(12, c, c, scale=0.05).bfloat16()
                sb = b if per_cloud else 1
                ss = torch.stack([rand(sb, 60 * c).abs() + 0.5,
                                  rand(sb, 60 * c, scale=0.3)], dim=1)
                out = torch.empty_like(f)
                if part == 'forward':
                    head = (f.data_ptr(), ti.data_ptr(), W.data_ptr())
                    tail = (out.data_ptr(), b, p, 60, 12, c, c)
                    args = head + (ss.data_ptr(),) + tail + (
                        2 * 60 * c if sb > 1 else 0, build.LEAKY_SLOPE)
                    plain_args = head + (0,) + tail + (0, build.LEAKY_SLOPE)
                    entry = 'epn_intra_conv_mma'
                    want = intra_conv.intra_conv_prenorm_plain(f, ss, ti, W)
                else:
                    dout = rand(b, p, 60, c).bfloat16()
                    Wt = W.transpose(1, 2).contiguous()
                    nj = -(-p // intra_conv.mma_block_points(c))
                    ws = torch.empty(2, nj, b, 60 * c, device=dev)
                    dss = torch.empty(2, sb, 60 * c, device=dev)
                    args = (dout.data_ptr(), inv.data_ptr(), Wt.data_ptr(),
                            f.data_ptr(), ss.data_ptr(), out.data_ptr(),
                            ws.data_ptr(), dss[0].data_ptr(),
                            dss[1].data_ptr(), b, p, 60, 12, c, c, sb,
                            build.LEAKY_SLOPE)
                    entry = 'epn_intra_conv_prenorm_df_mma'
                    want = intra_conv.intra_conv_prenorm_df_plain(
                        dout, f, ss, ti, W)[0]
                for n, fn in fns.items():
                    run = call(fn[entry], args)
                    key = f'{part} {n}'
                    rec[key] = {'ms': time_ms(run)}
                    if n in EXACT:
                        run()
                        torch.cuda.synchronize()
                        rec[key].update(rel=_rel(out, want),
                                        lean=_lean(out, want))
                if part == 'forward':
                    rec['forward no_fold'] = {'ms': time_ms(call(
                        fns['built'][entry], plain_args))}
                del f, W, ss, out, want
                torch.cuda.empty_cache()
            for k, v in rec.items():
                total[k] = total.get(k, 0.0) + v['ms']
            lines.append({'model': model, 'layer': tag, 'p': p, 'c': c,
                          'batch': [bf, bd], 'variants': rec, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
        lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                      'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _dw(fns, dev, card, stream, ti, time_ms):
    """B6 dW's variants, its plain form and the SGEMM at each layer (the
    step's batch): JSON lines."""
    lines = []
    names = ['built', 'dw_no_fold', 'dw_sgemm'] + list(DW_VARIANTS)
    for model, (_, b, per_cloud, layers) in SHAPES.items():
        total = dict.fromkeys(names, 0.0)
        for tag, p, c in layers:
            rng = np.random.RandomState(p + c + 1)

            def rand(*shape, scale=1.0):
                return torch.from_numpy((scale * rng.randn(*shape)).astype(
                    np.float32)).to(dev)
            f = rand(b, p, 60, c).bfloat16()
            dout = rand(b, p, 60, c).bfloat16()
            sb = b if per_cloud else 1
            ss = torch.stack([rand(sb, 60 * c).abs() + 0.5,
                              rand(sb, 60 * c, scale=0.3)], dim=1)
            want = intra_conv.intra_conv_prenorm_dw_plain(f, ss, ti, dout)
            dW = torch.empty(12, c, c, device=dev)
            bufs = {}
            for mma in (True, False):
                splits, rows = intra_conv.dw_splits(b * p, 60, 12, c, c, mma)
                ws = torch.empty(splits, 12, c, c, device=dev)
                bufs[mma] = (ws, (f.data_ptr(), ti.data_ptr(), ss.data_ptr(),
                                  dout.data_ptr(), ws.data_ptr(),
                                  dW.data_ptr(), b, p, 60, 12, c, c,
                                  2 * 60 * c if sb > 1 else 0,
                                  build.LEAKY_SLOPE, splits)
                             + ((rows,) if mma else (1,)))

            def call(n):
                lib = fns['built' if n in ('dw_no_fold', 'dw_sgemm') else n]
                args = bufs[n != 'dw_sgemm'][1]
                if n == 'dw_no_fold':
                    args = args[:2] + (0,) + args[3:12] + (0,) + args[13:]
                fn = lib['epn_intra_conv_bwd_w' if n == 'dw_sgemm' else
                         'epn_intra_conv_bwd_w_mma']

                def run():
                    err = fn(*args, stream)
                    if err:
                        raise RuntimeError(f'{n}: CUDA error {err}')
                return run
            rec = {}
            for n in names:
                rec[n] = {'ms': time_ms(call(n))}
                if n in ('built', 'dw_sgemm'):
                    call(n)()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(dW, want)
                total[n] += rec[n]['ms']
            lines.append({'model': model, 'layer': tag, 'p': p, 'c': c,
                          'batch': b, 'splits': bufs[True][1][-2],
                          'variants': rec, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del f, dout, ss, want, dW, bufs
            torch.cuda.empty_cache()
        lines.append({'model': model, 'entry': 'dw', 'sum_over_layers': True,
                      'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines



def _dw_f32(fns, dev, card, stream, ti, time_ms):
    """The fp32 CUDA-core dW's builds and the SGEMM at each layer (the
    step's batch), each timed in both orders: JSON lines."""
    lines = []
    names = ['sgemm'] + list(F32_VARIANTS)
    for model, (_, b, _, layers) in SHAPES.items():
        total = dict.fromkeys(names, 0.0)
        for tag, p, c in layers:
            rng = np.random.RandomState(p + c + 2)
            f = torch.from_numpy(rng.randn(b, p, 60, c).astype(
                np.float32)).to(dev)
            dout = torch.from_numpy(rng.randn(b, p, 60, c).astype(
                np.float32)).to(dev)
            want = intra_conv.intra_conv_dw_plain(f, ti, dout)
            dW = torch.empty(12, c, c, device=dev)
            bufs = {}
            for f32 in (True, False):
                splits, rows = (intra_conv.dw_f32_splits(b * p, 60, c, c)
                                if f32 else intra_conv.dw_splits(
                                    b * p, 60, 12, c, c, False))
                ws = torch.empty(splits, 12, c, c, device=dev)
                bufs[f32] = (ws, (f.data_ptr(), ti.data_ptr(), 0,
                                  dout.data_ptr(), ws.data_ptr(),
                                  dW.data_ptr(), b, p, 60, 12, c, c, 0)
                             + ((splits, rows) if f32 else
                                (build.LEAKY_SLOPE, splits, 0)))

            def call(n):
                fn = (fns['built']['epn_intra_conv_bwd_w'] if n == 'sgemm'
                      else fns[n]['epn_intra_conv_bwd_w_f32'])
                args = bufs[n != 'sgemm'][1]

                def run():
                    err = fn(*args, stream)
                    if err:
                        raise RuntimeError(f'{n}: CUDA error {err}')
                return run
            # each build timed in turn, then again in the reverse order: a
            # build's place in the order moved its time by ~10%
            rec = {n: {'ms': 0.0} for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    rec[n]['ms'] += time_ms(call(n)) / 2
            for n in F32_EXACT:
                call(n)()
                torch.cuda.synchronize()
                rec[n]['rel'] = _rel(dW, want)
            for n in names:
                total[n] += rec[n]['ms']
            lines.append({'model': model, 'entry': 'dw_f32', 'layer': tag,
                          'p': p, 'c': c, 'batch': b,
                          'splits': bufs[True][1][-2], 'variants': rec,
                          'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del f, dout, want, dW, bufs
            torch.cuda.empty_cache()
        lines.append({'model': model, 'entry': 'dw_f32',
                      'sum_over_layers': True, 'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _fwd_f32(fns, dev, card, stream, time_ms):
    """The fp32 forward's builds and the SGEMM at each layer and call (the
    cls forward at b=32 and b=12, its df at b=12, the inv forward at b=16),
    each timed in both orders: JSON lines."""
    lines = []
    names = ['fwd_sgemm'] + list(FWD_F32_VARIANTS)
    adj = {'trace': torch.from_numpy(icosahedron.get_intra_idx()).to(dev),
           'inv': torch.from_numpy(icosahedron.get_intra_inv_idx()).to(dev)}
    for model, calls in FWD_F32_CALLS.items():
        for call_name, b, which in calls:
            total = dict.fromkeys(names, 0.0)
            for tag, p, c in SHAPES[model][3]:
                rng = np.random.RandomState(p + c + b)
                f = torch.from_numpy(rng.randn(b, p, 60, c).astype(
                    np.float32)).to(dev)
                W = torch.from_numpy((0.05 * rng.randn(12, c, c)).astype(
                    np.float32)).to(dev)
                ti = adj[which]
                want64 = intra_conv.intra_conv_plain(f.double(), ti,
                                                     W.double())
                want = want64.float()
                out = torch.empty_like(f)
                args = (f.data_ptr(), ti.data_ptr(), W.data_ptr(), 0,
                        out.data_ptr(), b, p, 60, 12, c, c, 0)

                def call(n):
                    fn = (fns['built']['epn_intra_conv'] if n == 'fwd_sgemm'
                          else fns[n]['epn_intra_conv'] if
                          n.startswith('fwd_sgemm') else
                          fns[n]['epn_intra_conv_f32'])
                    tail = ((build.LEAKY_SLOPE, 0) if n.startswith('fwd_sgemm')
                            else ())

                    def run():
                        err = fn(*args, *tail, stream)
                        if err:
                            raise RuntimeError(f'{n}: CUDA error {err}')
                    return run
                rec = {n: {'ms': 0.0} for n in names}
                for order in (names, names[::-1]):
                    for n in order:
                        rec[n]['ms'] += time_ms(call(n)) / 2
                for n in FWD_F32_EXACT:
                    call(n)()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(out, want)
                    if n in ('fwd_sgemm', 'fwdf_built'):
                        rec[n]['rel_f64'] = float(
                            (out.double() - want64).norm() / want64.norm())
                for n in names:
                    total[n] += rec[n]['ms']
                lines.append({'model': model, 'entry': 'fwd_f32',
                              'call': call_name, 'layer': tag, 'p': p,
                              'c': c, 'batch': b, 'variants': rec,
                              'card': card})
                print(json.dumps(lines[-1]), flush=True)
                del f, W, want, want64, out
                torch.cuda.empty_cache()
            lines.append({'model': model, 'entry': 'fwd_f32',
                          'call': call_name, 'batch': b,
                          'sum_over_layers': True, 'ms': total,
                          'card': card})
            print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == '__main__':
    main()
