"""Where the bf16 tensor-core inter forward (``inter_conv_mma_kernel`` in
csrc/inter_conv.cu) and the bf16 tensor-core W-off F (``inter_f_mma_kernel``)
spend their time, on the card: each kernel as built beside variants with
one part taken out, at the shapes of the models' layers, with the same
timer (``chip_smoke.time_ms``).

  python -m epn_pointcloud_tpu_torch.inter_conv_variants

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

One JSON line a shape, a sum over each model's layers, all of them in
chiprun_out/inter_conv_variants.json. Needs a CUDA device and nvcc.
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


def _operands(dev, b, p1, p2, nn, c, d, seed):
    """Seeded bf16 table and W, fp32 neighborhoods of p2 of p1 random points
    in the unit ball (radius 0.4), the 60 rotated kernel points."""
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
        dev, torch.bfloat16)
    W = torch.from_numpy((0.05 * rng.randn(24, c, d)).astype(np.float32)).to(
        dev, torch.bfloat16)
    return gx.contiguous(), idx, table, rk, k2, W


def _build(variants, entry):
    """Each variant of csrc/inter_conv.cu built alone (all nvcc at once);
    variant -> its C entry ``entry``."""
    procs = {n: build.compile_alone(build.CSRC_DIR, 'inter_conv.cu',
                                    os.path.join(OUT, f'{entry}_{n}'), sub)
             for n, sub in variants.items()}
    fns = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {n}:\n{log}')
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit('inter_conv_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    fns = _build(VARIANTS, 'epn_inter_conv_mma')
    f_fns = _build(F_VARIANTS, 'epn_inter_conv_f_mma')
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    lines = (forward_part(fns, dev, card, time_ms)
             + f_part(f_fns, dev, card, time_ms))
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'inter_conv_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


if __name__ == '__main__':
    main()
