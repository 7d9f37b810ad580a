"""Where the bf16 tensor-core inter forward (``inter_conv_mma_kernel`` in
csrc/inter_conv.cu), the bf16 tensor-core W-off F (``inter_f_mma_kernel``),
the fp32 CUDA-core W-off F (``inter_f_f32_kernel``) and the fp32 CUDA-core
W-fused forward (``inter_fwd_f32_kernel``) spend their time, on the card:
each kernel as built beside variants with one part changed or taken out,
at the shapes of the models' layers, with the same timer
(``chip_smoke.time_ms``).

  python -m epn_pointcloud_tpu_torch.inter_conv_variants [--part NAME]

It imports ``chip_smoke`` from the repository root. Each variant is
csrc/inter_conv.cu compiled alone (nvcc, sm_90a) under
build/inter_conv_variants/ with one text substitution (which fails loudly
when the source no longer holds the text):
  built          the source as it is (the W product sums each pair of k16
                 steps in a fresh accumulator);
  in_place       every mma of the W product accumulates into the running
                 sum (the mma's truncating accumulation);
and, whose output is wrong and only whose time counts:
  no_gather      the table rows are not read (the neighbor buffers are
                 zero-filled): the gathers' share;
  no_contract    phase 1 computes nothing (no anchor weights, no neighbor
                 contraction, no F stores; the gathers still run);
  no_w_product   phase 2 issues no mma (its W loads, ldmatrix and barriers
                 still run);
  no_w_loads     phase 2 loads no W slice (its products run on stale
                 shared memory): the W stream's share;
  same_w_row     every W slice reads the same W row: all blocks hit the
                 same L2 lines.
For built and in_place also the normwise error against
``inter_conv_mma_plain`` (the plain version at the kernel's rounding
points) and the share of outputs rounded toward zero less the share
rounded away from it (``lean``). Operands are random (seeded), the
neighborhoods a ball query over random points in the unit ball, at the
shapes the smoke run captures from the models: cls_so3net_pn at b=32 and
inv_so3net_pn at b=16 (one leg).

The W-off F (``epn_inter_conv_f_mma``), at the inv model's composed-route
layers (b=16, one leg), beside the SGEMM template's W-off mode
(``epn_inter_conv_f`` in bf16, ``template``):
  built          the source as it is (each row's neighbor contraction sums
                 its <= 4 k16 steps in place in the mma accumulator);
  fresh_acc      each k16 step of the contraction in a fresh accumulator,
                 added to the running sum by a rounding fp32 add;
  ring_deep      the ring sized for two blocks an SM, not four: the next
                 pair's gathers in flight at nn = 64 too, at half the warps;
and, whose output is wrong and only whose time counts:
  no_stores      F is not stored (the staging still runs);
  no_gather      the table rows are not read (zero-filled buffers);
  no_mma         the contraction runs no mma (its anchor weights, ldmatrix
                 and stores still run).
For built, fresh_acc and ring_deep the normwise error against
``inter_conv_f_plain`` and the lean.

The fp32 W-off F (``epn_inter_conv_f_f32``) at the same layers, beside the
template's W-off mode in fp32 (``template``):
  built          the source as it is (a lane 3 kernel points x 32
                 channels, 8 lanes a row, three blocks an SM, the
                 neighbor loop not unrolled);
  kt6_ch16       a lane 6 kernel points x 16 channels (4 lanes a row);
  unroll_2       the neighbor loop unrolled by 2;
  blocks_2       registers asked for two blocks an SM (up to 255: over
                 168 only two fit);
and, whose output is wrong and only whose time counts:
  no_stores      F is not stored (the store tile is still written and
                 read);
  no_gather      the table rows are not read (the ring stages are
                 zero-filled);
  no_weights     every anchor weight is one constant (no weights computed,
                 no neighbor coordinates read).
Each build, the template too, is timed in turn and then in the reverse
order, and the two times averaged. For the builds whose output is right
the normwise error against ``inter_conv_f_plain`` and whether F equals
the template's bit for bit (``bitwise_vs_template``).

The fp32 W-fused forward (``epn_inter_conv_fwd_f32``) at the models'
layers, beside the SGEMM template in fp32 (``template``):
  built          the source as it is: at 256 columns 256 threads of 8 x 8
                 sums, F built 16 channels a chunk, one block an SM; at 128
                 256 threads of 8 x 4, at 64 and 32 128 threads (8 x 4,
                 4 x 4), 8 channels a chunk, two or three blocks an SM;
                 the slab k-major, the next row's fragments loaded while
                 this one's FFMA run;
  d256_ch8       at 256 columns 128 threads of 16 x 8 sums (0.75 shared
                 bytes a FFMA, 255 registers), 8 channels a chunk, two
                 blocks an SM;
  d256_ch8_nt256 at 256 columns 8 channels a chunk and a W ring of two
                 slices (every width), two blocks an SM (128 registers);
  d128_nt128     at 128 columns 128 threads of 8 x 8 sums;
  d64_nt256      at 64 and 32 columns 256 threads (4 x 4, 2 x 4);
  pf2            the product's fragments loaded two rows ahead;
  w_stages_2     a W ring of two slices, not three;
  unroll_2       the F build's neighbor loop unrolled by 2;
and, whose output is wrong and only whose time counts:
  no_build       no F is built (the slab holds zeros; the gathers that
                 run ahead still go out);
  no_product     the W product issues no FFMA (its loads and barriers
                 still run).
Each build timed in both orders as above; for the builds whose output is
right, whether it equals the built kernel's bit for bit (a build with
another chunk width sums the W product in another order) and its normwise
error against ``inter_conv_plain``.

For every build of each part, its kernel's registers and spills (nvcc's
-Xptxas -v). One JSON line a shape, a sum over each model's layers, a line
a build's registers, all of them in chiprun_out/inter_conv_variants.json
(``--part NAME``: that part alone, into
chiprun_out/inter_conv_variants_NAME.json). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import numpy as np
import torch

from .intra_conv_variants import _lean, _rel
from .ops import icosahedron, kernel_points, so3conv
from .ops.kernels import build, inter_conv

OUT = os.path.join(build.BUILD_DIR, 'inter_conv_variants')
ROOT = os.path.dirname(build.BUILD_DIR)
_MMA = 'tc::mma(t[mi][ni], af[mi], bf[ni][0], bf[ni][1]);'
# variant -> (text in the source, its replacement), or None for the source
VARIANTS = {
    'built': None,
    'in_place': (_MMA, 'tc::mma(acc[mi][ni], af[mi], bf[ni][0], '
                 'bf[ni][1]);'),
    'no_gather': ('const bool ok = j < q;', 'const bool ok = false;'),
    'no_contract': ('contract(2 * i);', 'if (M < 0) contract(2 * i);'),
    'no_w_product': (_MMA, 'if (M < 0) ' + _MMA),
    'no_w_loads': ('tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, BN / 8)),',
                   'if (M < 0) tc::cp16(tc::smem_addr(dst + tc::swz(r, c8, '
                   'BN / 8)),'),
    'same_w_row': ('W + ((size_t)k * C + c0 + cc) * D + n0 + c8, true);',
                   'W + n0 + c8, true);'),
}
EXACT = ('built', 'in_place')
_F_MMA = 'tc::mma(f[u][mi][j], af, b[j][0], b[j][1]);'
# the W-off F's builds, as VARIANTS
F_VARIANTS = {
    'built': None,
    'fresh_acc': (_F_MMA, '{ float t4[4] = {0.f, 0.f, 0.f, 0.f}; '
                  'tc::mma(t4, af, b[j][0], b[j][1]); for (int e = 0; '
                  'e < 4; ++e) f[u][mi][j][e] += t4[e]; }'),
    'ring_deep': ('constexpr int kFBlocks = 4;',
                  'constexpr int kFBlocks = 2;'),
    'no_stores': ('tc::st_stream16(out + (size_t)k * C + ch * 8,',
                  'if (M < 0) tc::st_stream16(out + (size_t)k * C + ch * 8,'),
    'no_gather': ('const bool ok = j < q;', 'const bool ok = false;'),
    'no_mma': (_F_MMA, 'if (inv_sigma < 0.f) ' + _F_MMA),
}
F_EXACT = ('built', 'fresh_acc', 'ring_deep')
# the fp32 W-off F's builds, as VARIANTS
_NO_WEIGHTS_STEP = """template <int KT, int N, typename Load4>
__device__ __forceinline__ void add_neighbor(float (&acc)[KT][N],
                                             const float4&,
                                             const float4 (&)[KT],
                                             float inv_sigma, Load4 load4) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 t = load4(h);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      acc[j][4 * h] = fmaf(inv_sigma, t.x, acc[j][4 * h]);
      acc[j][4 * h + 1] = fmaf(inv_sigma, t.y, acc[j][4 * h + 1]);
      acc[j][4 * h + 2] = fmaf(inv_sigma, t.z, acc[j][4 * h + 2]);
      acc[j][4 * h + 3] = fmaf(inv_sigma, t.w, acc[j][4 * h + 3]);
    }
  }
}
"""
F32_VARIANTS = {
    'built': None,
    'kt6_ch16': [('constexpr int kKT = 3;', 'constexpr int kKT = 6;'),
                 ('constexpr int kCH = 32;', 'constexpr int kCH = 16;')],
    'unroll_2': ('#pragma unroll 1\n        for (int n = 0; n < ns; ++n) {',
                 '#pragma unroll 2\n        for (int n = 0; n < ns; ++n) {'),
    'blocks_2': ('constexpr int kBlocks = 3;', 'constexpr int kBlocks = 2;'),
    'no_stores': ('if (lp >= 0) {', 'if (M < 0) {'),
    'no_gather': ('const bool live = j < q;', 'const bool live = false;'),
    # the step of inter_conv_common.cuh's add_neighbor, its weight a
    # constant, declared in the kernel's namespace in its place
    'no_weights': ('namespace ff32 {\n\nusing epn_inter::add_neighbor;\n',
                   'namespace ff32 {\n\n' + _NO_WEIGHTS_STEP),
}
F32_EXACT = ('built', 'kt6_ch16', 'unroll_2', 'blocks_2')
# the fp32 W-fused forward's builds, as VARIANTS: the block shape's two
# lines (threads; channels a chunk and gather stages) by the columns BN
_FWD_NT = '  static constexpr int NT = BN == 256 || BN == 128 ? 256 : 128;'
_FWD_CH = ('  static constexpr int CH = BN == 256 ? 16 : 8, '
           'GS = BN == 256 ? 3 : 2;')
_FWD_FMA = 'acc[i][j] = fmaf(a[f][i], b[f][j], acc[i][j]);'
FWD_F32_VARIANTS = {
    'built': None,
    'd256_ch8': [(_FWD_NT, _FWD_NT.replace('BN == 256 || ', '')),
                 (_FWD_CH, '  static constexpr int CH = 8, GS = 2;')],
    'd256_ch8_nt256': [(_FWD_CH, '  static constexpr int CH = 8, GS = 2;'),
                       ('constexpr int kWStages = 3;         // W ring slices',
                        'constexpr int kWStages = 2;         // W ring slices')],
    'd128_nt128': (_FWD_NT, _FWD_NT.replace(' || BN == 128', '')),
    'd64_nt256': (_FWD_NT, _FWD_NT.replace('BN == 256 || BN == 128',
                                           'BN >= 64')),
    'pf2': ('constexpr int kPF = 1;', 'constexpr int kPF = 2;'),
    'w_stages_2': ('constexpr int kWStages = 3;         // W ring slices',
                   'constexpr int kWStages = 2;         // W ring slices'),
    'unroll_2': ('#pragma unroll 1\n          for (int n = 0; n < ns; ++n) {',
                 '#pragma unroll 2\n          for (int n = 0; n < ns; ++n) {'),
    'no_build': ('      if (it < items) {', '      if (C < 0) {'),
    'no_product': (_FWD_FMA, 'if (C < 0) ' + _FWD_FMA),
}
FWD_F32_EXACT = ('built', 'd256_ch8', 'd256_ch8_nt256', 'd128_nt128',
                 'd64_nt256', 'pf2', 'w_stages_2', 'unroll_2')
SOURCE_PATH = os.path.join(build.CSRC_DIR, 'inter_conv.cu')
# model -> (b, [(layer, p1, p2, nn, c, d)])
SHAPES = {
    'cls_so3net_pn b=32': (32, [
        ('L1', 512, 512, 16, 64, 64), ('L2', 512, 256, 32, 64, 128),
        ('L3', 256, 256, 16, 128, 128), ('L4', 256, 128, 32, 128, 256),
        ('L5', 128, 128, 16, 256, 256), ('L6', 128, 64, 32, 256, 256)]),
    'inv_so3net_pn b=16': (16, [
        ('B0L1', 512, 512, 32, 32, 32), ('B1L0', 512, 256, 64, 32, 64),
        ('B1L1', 256, 256, 32, 64, 64), ('B2L0', 256, 128, 64, 64, 128),
        ('B2L1', 128, 128, 32, 128, 128), ('B3L0', 128, 64, 64, 128, 128),
        ('B3L1', 64, 64, 32, 128, 128)]),
}
# the inv model's composed-route layers: (layer, p1, p2, nn, c), b=16
F_SHAPES = (16, [('B0L1', 512, 512, 32, 32), ('B1L0', 512, 256, 64, 32),
                 ('B2L0', 256, 128, 64, 64), ('B3L0', 128, 64, 64, 128)])


def _operands(dev, b, p1, p2, nn, c, d, seed, dtype=torch.bfloat16):
    """Seeded table and W in ``dtype``, fp32 neighborhoods of p2 of p1
    random points in the unit ball (radius 0.4), the 60 rotated kernel
    points."""
    rng = np.random.RandomState(seed)
    v = rng.randn(b, p1, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    x = torch.from_numpy((v * rng.rand(b, p1, 1) ** (1 / 3)).astype(
        np.float32)).to(dev)
    gx, idx, _, _ = so3conv.sampling.inter_grouping_ball(x, p1 // p2, 0.4,
                                                         nn)
    anchors = torch.from_numpy(icosahedron.get_anchors(60)).to(dev)
    kern = torch.from_numpy(kernel_points.get_spherical_kernel_points(
        0.28, 1)).to(dev)
    rk, k2 = so3conv.rotated_kernels(anchors, kern)
    table = torch.from_numpy(rng.randn(b, p1, 60, c).astype(np.float32)).to(
        dev, dtype)
    W = torch.from_numpy((0.05 * rng.randn(24, c, d)).astype(np.float32)).to(
        dev, dtype)
    return gx.contiguous(), idx, table, rk, k2, W


def _build(variants, entry, kernel):
    """Each variant of csrc/inter_conv.cu built alone (all nvcc at once);
    (variant -> its C entry ``entry``, variant -> the registers and spills
    of each function whose name holds ``kernel``)."""
    from .inter_bwd_variants import ptxas_usage  # it imports this module
    procs = {n: build.compile_alone(build.CSRC_DIR, 'inter_conv.cu',
                                    os.path.join(OUT, f'{entry}_{n}'), sub)
             for n, sub in variants.items()}
    fns, regs = {}, {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {n}:\n{log}')
        regs[n] = ptxas_usage(log, kernel)
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns, regs


def _caller(fn, args, name):
    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'{name}: error {err}')
    return run


def forward_part(fns, dev, card, time_ms):
    lines = []
    for model, (b, layers) in SHAPES.items():
        total = dict.fromkeys(VARIANTS, 0.0)
        for tag, p1, p2, nn, c, d in layers:
            gx, idx, table, rk, k2, W = _operands(dev, b, p1, p2, nn, c, d,
                                                  seed=nn + c + d)
            out = torch.empty(b, p2, 60, d, dtype=torch.bfloat16, device=dev)
            args = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                    rk.data_ptr(), k2.data_ptr(), W.data_ptr(),
                    out.data_ptr(), b, p2, nn, p1, 60, 24, c, d, 0.08)
            rec = {n: time_ms(_caller(fn, args, 'epn_inter_conv_mma'))
                   for n, fn in fns.items()}
            for n, ms in rec.items():
                total[n] += ms
            want = inter_conv.inter_conv_mma_plain(gx, idx, table, rk, k2, W,
                                                   0.08)
            err = {}
            for n in EXACT:
                _caller(fns[n], args, n)()
                torch.cuda.synchronize()
                err[n] = {'rel': _rel(out, want), 'lean': _lean(out, want)}
            del want
            lines.append({'model': model, 'layer': tag,
                          'dims': [b, p1, p2, nn, c, d], 'ms': rec,
                          'vs_mma_plain': err, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, table, W, out
            torch.cuda.empty_cache()
        lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                      'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def f_part(fns, dev, card, time_ms):
    """The W-off F's builds and the template at the inv composed layers."""
    lib = build.library()
    b, layers = F_SHAPES
    model = f'inv_so3net_pn W-off F b={b}'
    total = dict.fromkeys(['template', *F_VARIANTS], 0.0)
    lines = []
    for tag, p1, p2, nn, c in layers:
        gx, idx, table, rk, k2, _ = _operands(dev, b, p1, p2, nn, c, 32,
                                              seed=nn + c)
        F = torch.empty(b, p2, 60, 24, c, dtype=torch.bfloat16, device=dev)
        args = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                rk.data_ptr(), k2.data_ptr(), F.data_ptr(), b, p2, nn, p1,
                60, 24, c, 0.08)
        rec = {'template': time_ms(_caller(lib.epn_inter_conv_f, args + (1,),
                                           'epn_inter_conv_f'))}
        rec.update({n: time_ms(_caller(fn, args, 'epn_inter_conv_f_mma'))
                    for n, fn in fns.items()})
        for n, ms in rec.items():
            total[n] += ms
        want = inter_conv.inter_conv_f_plain(gx, idx, table, rk, k2, 0.08)
        err = {}
        for n in F_EXACT:
            _caller(fns[n], args, n)()
            torch.cuda.synchronize()
            err[n] = {'rel': _rel(F, want), 'lean': _lean(F, want)}
        del want
        lines.append({'model': model, 'layer': tag,
                      'dims': [b, p1, p2, nn, c], 'ms': rec,
                      'vs_f_plain': err, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
        del gx, idx, table, F
        torch.cuda.empty_cache()
    lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                  'card': card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def f32_part(fns, dev, card, time_ms):
    """The fp32 W-off F's builds and the template at the inv composed
    layers."""
    lib = build.library()
    b, layers = F_SHAPES
    model = f'inv_so3net_pn fp32 W-off F b={b}'
    total = dict.fromkeys(['template', *F32_VARIANTS], 0.0)
    lines = []
    for tag, p1, p2, nn, c in layers:
        gx, idx, table, rk, k2, _ = _operands(dev, b, p1, p2, nn, c, 32,
                                              seed=nn + c,
                                              dtype=torch.float32)
        F = torch.empty(b, p2, 60, 24, c, device=dev)
        args = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                rk.data_ptr(), k2.data_ptr(), F.data_ptr(), b, p2, nn, p1,
                60, 24, c, 0.08)
        template = _caller(lib.epn_inter_conv_f, args + (0,),
                           'epn_inter_conv_f')
        runs = {'template': template}
        runs.update({n: _caller(fn, args, 'epn_inter_conv_f_f32')
                     for n, fn in fns.items()})
        # each build timed in turn, then again in the reverse order: a
        # build's place in the order moved its time by ~10%
        rec = dict.fromkeys(runs, 0.0)
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                rec[n] += time_ms(runs[n]) / 2
        for n, ms in rec.items():
            total[n] += ms
        template()
        want = F.clone()
        plain = inter_conv.inter_conv_f_plain(gx, idx, table, rk, k2, 0.08)
        err = {}
        for n in F32_EXACT:
            _caller(fns[n], args, n)()
            torch.cuda.synchronize()
            err[n] = {'bitwise_vs_template': torch.equal(F, want),
                      'rel': _rel(F, plain)}
        del want, plain
        lines.append({'model': model, 'layer': tag,
                      'dims': [b, p1, p2, nn, c], 'ms': rec,
                      'vs_f_plain': err, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
        del gx, idx, table, F
        torch.cuda.empty_cache()
    lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                  'card': card})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def fwd_f32_part(fns, dev, card, time_ms):
    """The fp32 W-fused forward's builds and the template at the models'
    layers."""
    lib = build.library()
    lines = []
    for model, (b, layers) in SHAPES.items():
        model = f'{model} fp32'
        total = dict.fromkeys(['template', *FWD_F32_VARIANTS], 0.0)
        for tag, p1, p2, nn, c, d in layers:
            gx, idx, table, rk, k2, W = _operands(dev, b, p1, p2, nn, c, d,
                                                  seed=nn + c,
                                                  dtype=torch.float32)
            out = torch.empty(b, p2, 60, d, device=dev)
            args = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                    rk.data_ptr(), k2.data_ptr(), W.data_ptr(),
                    out.data_ptr(), b, p2, nn, p1, 60, 24, c, d, 0.08)
            runs = {'template': _caller(lib.epn_inter_conv, args + (0,),
                                        'epn_inter_conv')}
            runs.update({n: _caller(fn, args, 'epn_inter_conv_fwd_f32')
                         for n, fn in fns.items()})
            rec = dict.fromkeys(runs, 0.0)
            for order in (list(runs), list(runs)[::-1]):
                for n in order:
                    rec[n] += time_ms(runs[n]) / 2
            for n, ms in rec.items():
                total[n] += ms
            plain = inter_conv.inter_conv_plain(gx, idx, table, rk, k2, W,
                                                0.08)
            err, want = {}, None
            for n in FWD_F32_EXACT:
                runs[n]()
                torch.cuda.synchronize()
                want = out.clone() if want is None else want
                err[n] = {'bitwise_vs_built': torch.equal(out, want),
                          'rel': _rel(out, plain)}
            del want, plain
            lines.append({'model': model, 'layer': tag,
                          'dims': [b, p1, p2, nn, c, d], 'ms': rec,
                          'vs_plain': err, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
            del gx, idx, table, W, out
            torch.cuda.empty_cache()
        lines.append({'model': model, 'sum_over_layers': True, 'ms': total,
                      'card': card})
        print(json.dumps(lines[-1]), flush=True)
    return lines


# part -> (builds, C entry, kernel, the part's timing function)
PARTS = {'mma': (VARIANTS, 'epn_inter_conv_mma', 'inter_conv_mma_kernel',
                 forward_part),
         'f_mma': (F_VARIANTS, 'epn_inter_conv_f_mma', 'inter_f_mma_kernel',
                   f_part),
         'f_f32': (F32_VARIANTS, 'epn_inter_conv_f_f32', 'inter_f_f32_kernel',
                   f32_part),
         'fwd_f32': (FWD_F32_VARIANTS, 'epn_inter_conv_fwd_f32',
                     'inter_fwd_f32_kernel', fwd_f32_part)}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--part', choices=sorted(PARTS), default=None,
                    help='run this part alone (default: every part)')
    part = ap.parse_args(argv).part
    if not torch.cuda.is_available():
        raise SystemExit('inter_conv_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    lines = []
    for variants, entry, kernel, run in ([PARTS[part]] if part else
                                         PARTS.values()):
        fns, regs = _build(variants, entry, kernel)
        lines += run(fns, dev, card, time_ms)
        for n, use in regs.items():
            for fn_name, u in use.items():
                lines.append({'build': n, 'function': fn_name, **u})
                print(json.dumps(lines[-1]), flush=True)
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    name = f'inter_conv_variants_{part}' if part else 'inter_conv_variants'
    with open(os.path.join(out_dir, f'{name}.json'), 'w') as f:
        json.dump(lines, f, indent=1)


if __name__ == '__main__':
    main()
