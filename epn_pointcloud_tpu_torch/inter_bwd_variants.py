"""Where the inter backward kernels (csrc/inter_conv_bwd.cu: the bf16
tensor-core ``inter_bwd_mma_kernel``, the fused dTable and the W-off dG,
and ``inter_dw_mma_kernel``, the fused dW; the fp32 CUDA-core
``inter_dw_f32_kernel`` and the template ``inter_dw_kernel``; the fp32
CUDA-core scatter ``inter_bwd_f32_kernel`` and the template
``inter_dtable_kernel``) spend their time, on the card: each kernel as
built beside variants with one part changed or taken out, at the shapes
of both models' layers, with the same timer (``chip_smoke.time_ms``).

  python -m epn_pointcloud_tpu_torch.inter_bwd_variants

It imports ``chip_smoke`` from the repository root. Each variant is
csrc/inter_conv_bwd.cu compiled alone (nvcc, sm_90a) under
build/inter_bwd_variants/ with one text substitution (which fails loudly
when the source no longer holds the text):
  built          the source as it is (vector reductions, float4);
  scalar_red     four scalar reductions in place of each vector one;
  warps_8        8 warps a block (2 x 4 warps of 64 x 32 over a piece of
                 the dF product) in place of 16 (4 x 4 of 32 x 32);
  stages_4       a 4-stage ring of dout and W slices in place of 3;
and, whose output is wrong and only whose time counts:
  plain_stores   plain 16-byte stores in place of the reductions: the
                 atomics' share over the traffic itself;
  no_red         nothing written (the slot sums dropped): the scatter's
                 whole share;
  no_mma         the dF product issues no mma (its loads, barriers and
                 epilogue still run; the fused entry only);
  no_weights     the anchor weights not computed (a constant in the
                 fragments).
For built, scalar_red, warps_8 and stages_4 also the normwise error
against the plain version (``inter_conv_dtable_plain`` /
``inter_conv_dg_plain``, the same rounding points). The dW kernel's
variants (the scatter's sources compiled once more with one substitution
in the dW kernel), whose output is wrong and only whose time counts:
  dw_no_mma      the dW product issues no mma (its fragment loads and
                 fresh-accumulator adds still run);
  dw_no_contract the F slab's neighbor contraction left out (no anchor
                 weights, no mma, no slab stores; the gathers run);
  dw_no_gather   the table rows not gathered (the contraction runs on
                 whatever the buffers hold);
  dw_no_fbuild   both: the product, the dout tiles, the neighbor staging
                 and the barriers alone;
and beside them, from the built library, the template (``inter_dw_kernel``,
``epn_inter_conv_bwd_w``, the route before the tensor-core kernel) on the
same inputs; the built kernel's and the template's normwise error against
``inter_conv_dw_plain``. The fp32 dW: the template
(``inter_dw_kernel<float>``, ``epn_inter_conv_bwd_w``) and the CUDA-core
kernel (``inter_dw_f32_kernel``, ``epn_inter_conv_bwd_w_f32``) as built,
each one's error against ``inter_conv_dw_plain``, and, whose output is
wrong and only whose time counts,
  tpl_no_gather  the template's table rows not loaded (read as zeros; the
                 anchor weights and the F sums still run);
  tpl_no_fbuild  the template's F slab not built (left as staged);
  tpl_no_product the template's F^T dout product left out (its loads too);
  f32_no_gather  the kernel's gathers not issued (the F build reads
                 whatever the buffer holds);
  f32_no_fbuild  the kernel's F slab not built;
  f32_no_product the kernel's product left out (its loads too);
  f32_product_only the kernel's product alone (no gathers, no F build,
                 no dout loads: the loop on whatever shared memory holds);
and beside them, exact, with its error, f32_bn128: the built kernel
called with 128 d columns a block at d = 256 (two blocks an SM, F built
twice) in place of 256; with each fp32 build's registers and spill bytes
(ptxas). The fp32 backward scatter (the fused dTable and the W-off dG): the
template (``inter_dtable_kernel<float, *>``, ``epn_inter_conv_bwd_table`` /
``epn_inter_conv_dg`` with the dtype flag 0) and the CUDA-core kernel
(``inter_bwd_f32_kernel``, ``epn_inter_conv_bwd_table_f32`` /
``epn_inter_conv_dg_f32``) as built, each one's error against
``inter_conv_dtable_plain`` / ``inter_conv_dg_plain``, and, whose output is
wrong and only whose time counts,
  tpl_no_product   the template's dF product left out (its loads too);
  tpl_no_wstage    the template's W slices not staged (the product runs on
                   whatever shared memory holds);
  tpl_no_weights   the template's anchor weights not computed (a constant);
  tpl_plain_stores plain stores in place of its atomics;
  tpl_no_write     nothing written (the scatter's sums dropped);
  sc32_no_product  the kernel's dF product left out (its loads too);
  sc32_no_wload    the kernel's W^T slices not loaded;
  sc32_no_weights  the kernel's anchor weights not computed (a constant);
  sc32_plain_stores plain 16-byte stores in place of its vector reductions;
  sc32_no_write    nothing written (the scatter's sums dropped);
the product variants at the fused dTable's layers only.
Operands are random (seeded), the neighborhoods a ball query over random points in the unit
ball, at the shapes of cls_so3net_pn's step (b=12: the fused dTable at its
6 inter layers) and inv_so3net_pn's (b=16 a leg: the fused dTable at B1L1,
B2L1, B3L1, the W-off dG at B0L1, B1L0, B2L0, B3L0; the fused dW at the
fused dTable's layers). One JSON line a shape, a sum over each model's
calls, all of them in chiprun_out/inter_bwd_variants.json. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys

import numpy as np
import torch

from .intra_conv_variants import _rel
from .inter_conv_variants import _operands
from .ops.kernels import build, inter_conv

OUT = os.path.join(build.BUILD_DIR, 'inter_bwd_variants')
SOURCE_PATH = os.path.join(build.CSRC_DIR, 'inter_conv_bwd.cu')
ROOT = os.path.dirname(build.BUILD_DIR)
_RED = 'atomicAdd(reinterpret_cast<float4*>(dst), v);'
_MMA = 'tc::mma(f[mi][ni], af[mi], bf[ni][0], bf[ni][1]);'
# variant -> (text in the source, its replacement), or None for the source
VARIANTS = {
    'built': None,
    'scalar_red': (_RED, 'atomicAdd(dst, v.x); atomicAdd(dst + 1, v.y); '
                   'atomicAdd(dst + 2, v.z); atomicAdd(dst + 3, v.w);'),
    'plain_stores': (_RED, '*reinterpret_cast<float4*>(dst) = v;'),
    'no_red': ('if (j < q) red4(', 'if (j < q && C < 0) red4('),
    'no_mma': (_MMA, 'if (C < 0) ' + _MMA),
    'no_weights': ('w[u][j] = weight(gq[u], kr[j]);', 'w[u][j] = 0.5f;'),
    'warps_8': ('constexpr int kWarps = 16;', 'constexpr int kWarps = 8;'),
    'stages_4': ('constexpr int kStages = 3;', 'constexpr int kStages = 4;'),
}
_DW_MMA = 'tc::mma(f, af[ks], bf[ks][ni][0], bf[ks][ni][1]);'
_DW_CONTRACT = ('i += 2) contract(i, s);',
                'i += 2) if (C < 0) contract(i, s);')
_DW_GATHER = ('if (lp < 0) continue;', 'if (lp < 0 || C > 0) continue;')
DW_VARIANTS = {
    'dw_no_mma': (_DW_MMA, 'if (C < 0) ' + _DW_MMA),
    'dw_no_contract': _DW_CONTRACT,
    'dw_no_gather': _DW_GATHER,
    'dw_no_fbuild': [_DW_CONTRACT, _DW_GATHER],
}
# the fp32 dW template's variants (inter_dw_kernel<float, BN>)
DW_F32_VARIANTS = {
    'tpl_no_gather': ('m0 + row, m_end, pt0, p2, nn, q, na, NK,',
                      'm0 + row, m_end, pt0, p2, nn, 0, na, NK,'),
    'tpl_no_fbuild': ('for (int e = tid; e < W_BM * (NK / KG);',
                      'for (int e = tid; C < 0 && e < W_BM * (NK / KG);'),
    'tpl_no_product': ('j < TN; ++j) acc[i][j] = fmaf(',
                       'j < TN; ++j) if (C < 0) acc[i][j] = fmaf('),
    # the fp32 kernel's (inter_dw_f32_kernel<BN>)
    'f32_no_gather': ('lane; lp >= 0 && e < nn * (kCC / 4);',
                      'lane; C < 0 && e < nn * (kCC / 4);'),
    'f32_no_fbuild': ('    build_f(s);\n', '    if (C < 0) build_f(s);\n'),
    'f32_no_product': ('acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);',
                       'if (C < 0) acc[i][jj] = fmaf(a[i], b[jj], '
                       'acc[i][jj]);'),
    'f32_product_only': [('lane; lp >= 0 && e < nn * (kCC / 4);',
                          'lane; C < 0 && e < nn * (kCC / 4);'),
                         ('    build_f(s);\n', '    if (C < 0) build_f(s);\n'),
                         ('    dout_tile(m0);\n',
                          '    if (C < 0) dout_tile(m0);\n')],
}
# the fp32 scatter's: the template's (inter_dtable_kernel<float, *>) and
# the CUDA-core kernel's (inter_bwd_f32_kernel)
_SC32_RED = 'for (int h = 0; h < kCC / 4; ++h) red4(dst + 4 * h, v[h]);'
SCATTER_F32_VARIANTS = {
    'tpl_no_product': ('j < 6; ++j) acc[i][j] = fmaf(',
                       'j < 6; ++j) if (C < 0) acc[i][j] = fmaf('),
    'tpl_no_wstage': ('for (int e = tid; e < NCOL * T_BK / 4;',
                      'for (int e = tid; C < 0 && e < NCOL * T_BK / 4;'),
    'tpl_no_weights': ('const float w = anchor_weight(g, r, inv_sigma);',
                       'const float w = 0.5f;'),
    'tpl_plain_stores': ('atomicAdd(dst + cc, kWOff ?',
                         'dst[cc] = (kWOff ?'),
    'tpl_no_write': ('atomicAdd(dst + cc, kWOff ?',
                     'if (C < 0) atomicAdd(dst + cc, kWOff ?'),
    'sc32_no_product': ('acc[i][n] = fmaf(a[i], b[n], acc[i][n]);',
                        'if (C < 0) acc[i][n] = fmaf(a[i], b[n], '
                        'acc[i][n]);'),
    'sc32_no_wload': ('for (int e = tid; e < kStage / 4; e += kPThreads) {',
                      'for (int e = tid; e < (C < 0 ? kStage : kSD * kBM) '
                      '/ 4; e += kPThreads) {'),
    'sc32_no_weights': ('const float w = weight(g, kp[k]);',
                        'const float w = 0.5f;'),
    'sc32_plain_stores': (_SC32_RED, 'for (int h = 0; h < kCC / 4; ++h) '
                          '*reinterpret_cast<float4*>(dst + 4 * h) = v[h];'),
    'sc32_no_write': (_SC32_RED, 'if (C < 0) ' + _SC32_RED),
}
# the variants that change the fused entry's product (timed at the fused
# dTable's layers only)
FUSED_ONLY = ('tpl_no_product', 'tpl_no_wstage', 'sc32_no_product',
              'sc32_no_wload')
EXACT = ('built', 'scalar_red', 'warps_8', 'stages_4')
EXACT_F32 = ('template', 'f32', 'f32_bn128')
ENTRIES = {'dtable': 'epn_inter_conv_bwd_table_mma',
           'dg': 'epn_inter_conv_dg_mma', 'dw': 'epn_inter_conv_bwd_w_mma',
           'dw_template': 'epn_inter_conv_bwd_w',
           'dw_f32': 'epn_inter_conv_bwd_w_f32',
           'dtable_tpl': 'epn_inter_conv_bwd_table',
           'dg_tpl': 'epn_inter_conv_dg',
           'dtable_f32': 'epn_inter_conv_bwd_table_f32',
           'dg_f32': 'epn_inter_conv_dg_f32'}
# model -> (b, [(layer, entry, p1, p2, nn, c, d)])
SHAPES = {
    'cls_so3net_pn b=12': (12, [
        ('L1', 'dtable', 512, 512, 16, 64, 64),
        ('L2', 'dtable', 512, 256, 32, 64, 128),
        ('L3', 'dtable', 256, 256, 16, 128, 128),
        ('L4', 'dtable', 256, 128, 32, 128, 256),
        ('L5', 'dtable', 128, 128, 16, 256, 256),
        ('L6', 'dtable', 128, 64, 32, 256, 256)]),
    'inv_so3net_pn b=16': (16, [
        ('B0L1', 'dg', 512, 512, 32, 32, 32),
        ('B1L0', 'dg', 512, 256, 64, 32, 64),
        ('B1L1', 'dtable', 256, 256, 32, 64, 64),
        ('B2L0', 'dg', 256, 128, 64, 64, 128),
        ('B2L1', 'dtable', 128, 128, 32, 128, 128),
        ('B3L0', 'dg', 128, 64, 64, 128, 128),
        ('B3L1', 'dtable', 64, 64, 32, 128, 128)]),
}


def main():
    if not torch.cuda.is_available():
        raise SystemExit('inter_bwd_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    variants = {**VARIANTS, **DW_VARIANTS, **DW_F32_VARIANTS,
                **SCATTER_F32_VARIANTS}
    procs = {n: build.compile_alone(build.CSRC_DIR, 'inter_conv_bwd.cu',
                                    os.path.join(OUT, n), sub)
             for n, sub in variants.items()}
    fns, regs = {}, {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {n}:\n{log}')
        regs[n] = ptxas_usage(log, 'inter_')
        lib = ctypes.CDLL(so)
        fns[n] = {}
        for key, entry in ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[n][key] = fn
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    stream = torch.cuda.current_stream().cuda_stream
    lines = _scatter(fns, dev, card, stream, time_ms)
    lines += _dw(fns, dev, card, stream, time_ms)
    for n in ('built',) + tuple(DW_F32_VARIANTS) + tuple(
            SCATTER_F32_VARIANTS):
        for fn_name, use in regs[n].items():
            # the fp32 instantiations of the templates and the fp32 kernels
            if 'kernelIf' not in fn_name and 'f32' not in fn_name:
                continue
            lines.append({'build': n, 'function': fn_name, **use})
            print(json.dumps(lines[-1]), flush=True)
    lines += _dw_f32(fns, dev, card, stream, time_ms)
    lines += _scatter_f32(fns, dev, card, stream, time_ms)
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'inter_bwd_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


def ptxas_usage(log, key):
    """{function: {'registers', 'spill_stores', 'spill_loads', 'smem'}} of
    each kernel whose (mangled) name holds ``key``, from nvcc's -Xptxas -v
    output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if key in m.group(1) else None
            if fn:
                out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out[fn]['spill_stores'] = int(m.group(1))
            out[fn]['spill_loads'] = int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[fn]['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', line)
            out[fn]['static_smem'] = int(m.group(1)) if m else 0
    return out


def _scatter(fns, dev, card, stream, time_ms):
    """The scatter's variants (dTable, dG) at each layer: JSON lines."""
    lines = []
    for model, (b, layers) in SHAPES.items():
        total = {}
        for tag, entry, p1, p2, nn, c, d in layers:
            gx, idx, _, rk, k2, W = _operands(dev, b, p1, p2, nn, c, d,
                                              seed=nn + c + d)
            rng = np.random.RandomState(p2 + c)
            dT = torch.zeros(b, p1, 60, c, device=dev)
            if entry == 'dtable':
                src = torch.from_numpy(rng.randn(b, p2, 60, d).astype(
                    np.float32)).to(dev, torch.bfloat16)
                args = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(),
                        k2.data_ptr(), W.data_ptr(), src.data_ptr(),
                        dT.data_ptr(), b, p2, nn, p1, 60, 24, c, d, 0.08)
                want = inter_conv.inter_conv_dtable_plain(
                    gx, idx, p1, rk, k2, W, src, 0.08)
            else:
                src = torch.from_numpy(rng.randn(b, p2, 60, 24, c).astype(
                    np.float32)).to(dev, torch.bfloat16)
                args = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(),
                        k2.data_ptr(), src.data_ptr(), dT.data_ptr(), b, p2,
                        nn, p1, 60, 24, c, 0.08)
                want = inter_conv.inter_conv_dg_plain(gx, idx, p1, rk, k2,
                                                      src, 0.08)

            def call(fn):
                def run():
                    err = fn(*args, stream)
                    if err:
                        raise RuntimeError(f'{ENTRIES[entry]}: CUDA error '
                                           f'{err}')
                return run
            rec = {}
            for n, fn in fns.items():
                if n not in VARIANTS:
                    continue
                rec[n] = {'ms': time_ms(call(fn[entry]))}
                if n in EXACT:
                    dT.zero_()
                    call(fn[entry])()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(dT, want)
                total[n] = total.get(n, 0.0) + rec[n]['ms']
            lines.append({'model': model, 'layer': tag, 'entry': entry,
                          'dims': [b, p1, p2, nn, c, d], 'variants': rec,
                          'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, W, src, dT, want
            torch.cuda.empty_cache()
        lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                      'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _dw(fns, dev, card, stream, time_ms):
    """The dW kernel's variants and the template at each fused-route layer
    (the dTable's shapes): JSON lines."""
    lines = []
    names = ['built', 'dw_template'] + list(DW_VARIANTS)
    for model, (b, layers) in SHAPES.items():
        total = dict.fromkeys(names, 0.0)
        for tag, entry, p1, p2, nn, c, d in layers:
            if entry != 'dtable':
                continue
            gx, idx, table, rk, k2, _ = _operands(dev, b, p1, p2, nn, c, d,
                                                  seed=nn + c + d)
            rng = np.random.RandomState(p2 + c)
            dout = torch.from_numpy(rng.randn(b, p2, 60, d).astype(
                np.float32)).to(dev, torch.bfloat16)
            want = inter_conv.inter_conv_dw_plain(gx, idx, table, rk, k2,
                                                  dout, 0.08)
            dW = torch.empty(24, c, d, device=dev)
            bufs = {}
            for mma in (True, False):
                splits = inter_conv.dw_splits(b * p2 * 60, c, d,
                                              "dw_mma" if mma else "dw")
                ws = torch.empty(splits, 24, c, d, device=dev)
                bufs[mma] = (ws, (gx.data_ptr(), idx.data_ptr(),
                                  table.data_ptr(), rk.data_ptr(),
                                  k2.data_ptr(), dout.data_ptr(),
                                  ws.data_ptr(), dW.data_ptr(), b, p2, nn,
                                  p1, 60, 24, c, d, 0.08, splits))

            def call(n):
                fn = fns['built' if n == 'dw_template' else n][
                    'dw_template' if n == 'dw_template' else 'dw']
                tail = (1,) if n == 'dw_template' else ()
                args = bufs[n != 'dw_template'][1] + tail

                def run():
                    err = fn(*args, stream)
                    if err:
                        raise RuntimeError(f'{n}: CUDA error {err}')
                return run
            rec = {}
            for n in names:
                rec[n] = {'ms': time_ms(call(n))}
                if n in ('built', 'dw_template'):
                    call(n)()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(dW, want)
                total[n] += rec[n]['ms']
            lines.append({'model': model, 'layer': tag, 'entry': 'dw',
                          'dims': [b, p1, p2, nn, c, d],
                          'splits': bufs[True][1][-1], 'variants': rec,
                          'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, table, dout, want, dW, bufs
            torch.cuda.empty_cache()
        lines.append({'model': model, 'entry': 'dw', 'sum_over_layers': True,
                      'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _dw_f32(fns, dev, card, stream, time_ms):
    """The fp32 dW at each fused-route layer: the template and the CUDA-core
    kernel as built and their variants, each one's time, and the built
    ones' normwise error against ``inter_conv_dw_plain``: JSON lines."""
    lines = []
    names = ['template', 'f32', 'f32_bn128'] + list(DW_F32_VARIANTS)
    for model, (b, layers) in SHAPES.items():
        total = dict.fromkeys(names, 0.0)
        for tag, entry, p1, p2, nn, c, d in layers:
            if entry != 'dtable':
                continue
            gx, idx, table, rk, k2, _ = _operands(dev, b, p1, p2, nn, c, d,
                                                  seed=nn + c + d)
            table = table.float()
            rng = np.random.RandomState(p2 + c)
            dout = torch.from_numpy(rng.randn(b, p2, 60, d).astype(
                np.float32)).to(dev)
            want = inter_conv.inter_conv_dw_plain(gx, idx, table, rk, k2,
                                                  dout, 0.08)
            dW = torch.empty(24, c, d, device=dev)
            M = b * p2 * 60
            bn = inter_conv.dw_f32_cols(d)
            # f32_bn128: at most 128 columns a block
            bns = {'f32': bn, 'f32_bn128': min(bn, 128)}
            splits = {'template': inter_conv.dw_splits(M, c, d, 'dw'),
                      **{n: inter_conv.dw_splits(M, c, d, 'dw_f32', v)
                         for n, v in bns.items()}}
            ws = torch.empty(max(splits.values()), 24, c, d, device=dev)

            def call(n):
                tpl = n == 'template' or n.startswith('tpl_')
                fn = fns[n if n in DW_F32_VARIANTS else 'built'][
                    'dw_template' if tpl else 'dw_f32']
                key = 'template' if tpl else n if n in bns else 'f32'
                tail = (0,) if tpl else (bns[key],)
                args = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                        rk.data_ptr(), k2.data_ptr(), dout.data_ptr(),
                        ws.data_ptr(), dW.data_ptr(), b, p2, nn, p1, 60, 24,
                        c, d, 0.08, splits[key]) + tail

                def run():
                    err = fn(*args, stream)
                    if err:
                        raise RuntimeError(f'{n}: CUDA error {err}')
                return run
            rec = {}
            for n in names:
                rec[n] = {'ms': time_ms(call(n))}
                if n in EXACT_F32:
                    call(n)()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(dW, want)
                total[n] += rec[n]['ms']
            lines.append({'model': model, 'layer': tag, 'entry': 'dw_f32',
                          'dims': [b, p1, p2, nn, c, d], 'splits': splits,
                          'bn': bns, 'variants': rec, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, table, dout, want, dW, ws
            torch.cuda.empty_cache()
        lines.append({'model': model, 'entry': 'dw_f32',
                      'sum_over_layers': True, 'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def _scatter_f32(fns, dev, card, stream, time_ms):
    """The fp32 scatter (dTable, dG) at each layer: the template and the
    CUDA-core kernel as built and their variants, each one's time, and the
    built ones' normwise error against the plain version: JSON lines."""
    lines = []
    names = ['template', 'f32'] + list(SCATTER_F32_VARIANTS)
    for model, (b, layers) in SHAPES.items():
        total = {}
        for tag, entry, p1, p2, nn, c, d in layers:
            gx, idx, _, rk, k2, W = _operands(dev, b, p1, p2, nn, c, d,
                                              seed=nn + c + d)
            W = W.float()
            rng = np.random.RandomState(p2 + c)
            dT = torch.zeros(b, p1, 60, c, device=dev)
            if entry == 'dtable':
                src = torch.from_numpy(rng.randn(b, p2, 60, d).astype(
                    np.float32)).to(dev)
                args = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(),
                        k2.data_ptr(), W.data_ptr(), src.data_ptr(),
                        dT.data_ptr(), b, p2, nn, p1, 60, 24, c, d, 0.08)
                want = inter_conv.inter_conv_dtable_plain(
                    gx, idx, p1, rk, k2, W, src, 0.08)
                ws = torch.empty(inter_conv.bwd_f32_workspace(
                    b, p2, 24, c, d), device=dev)
                tail = (ws.data_ptr(),)
            else:
                src = torch.from_numpy(rng.randn(b, p2, 60, 24, c).astype(
                    np.float32)).to(dev)
                args = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(),
                        k2.data_ptr(), src.data_ptr(), dT.data_ptr(), b, p2,
                        nn, p1, 60, 24, c, 0.08)
                want = inter_conv.inter_conv_dg_plain(gx, idx, p1, rk, k2,
                                                      src, 0.08)
                tail = ()

            def call(n):
                tpl = n == 'template' or n.startswith('tpl_')
                fn = fns['built' if n in ('template', 'f32') else n][
                    f'{entry}_tpl' if tpl else f'{entry}_f32']
                full = args + ((0,) if tpl else tail)

                def run():
                    err = fn(*full, stream)
                    if err:
                        raise RuntimeError(f'{n}: CUDA error {err}')
                return run
            rec = {}
            for n in names:
                if entry == 'dg' and n in FUSED_ONLY:
                    continue
                rec[n] = {'ms': time_ms(call(n))}
                if n in ('template', 'f32'):
                    dT.zero_()
                    call(n)()
                    torch.cuda.synchronize()
                    rec[n]['rel'] = _rel(dT, want)
                total[f'{entry} {n}'] = total.get(f'{entry} {n}', 0.0) + \
                    rec[n]['ms']
            lines.append({'model': model, 'layer': tag,
                          'entry': f'{entry}_f32',
                          'dims': [b, p1, p2, nn, c, d], 'variants': rec,
                          'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, W, src, dT, want
            torch.cuda.empty_cache()
        lines.append({'model': model, 'entry': 'scatter_f32',
                      'sum_over_layers': True, 'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == '__main__':
    main()
