"""Where the bf16 grouped conv kernels (csrc/grouped_conv.cu) spend their
time, on the card: the kernels as built beside the one PyTorch call that
computes the same function, a variant without the forward's output stores,
and optionally the kernels of an earlier tree, all on the same inputs with
the same timer (``chip_smoke.time_ms``, in turns: ``time_abba``).

  python -m epn_pointcloud_tpu_torch.grouped_conv_variants \\
      [--parent-csrc DIR]

It imports ``chip_smoke`` from the repository root. Each build is
csrc/grouped_conv.cu compiled alone (nvcc, sm_90a) under
build/grouped_conv_variants/:
  built       the source as it is; the backward also in two launches (dx
              alone, then dW and dbias alone: ``parts`` 1 and 2);
  no_stores   the forward runs its products and its epilogue into the
              staged tile but does not store the tile to device memory
              (one text substitution, which fails loudly when the source
              no longer holds the text): the output stores' share;
  parent      with --parent-csrc, DIR's grouped_conv.cu: the kernels before
              the tensor-core redesign (ABI of ``epn_grouped_conv_bwd_w``),
              called as their wrappers called them (dx on a transposed
              copy of W; dbias as the widened sum of dout).
DIR is the csrc/ directory of an earlier tree, for example from
``git archive <commit> epn_pointcloud_tpu_torch/csrc | tar -x -C DIR0``.
Built and parent are timed in the order parent, built, built, parent and
each pair is averaged. The shapes are the main paths': the cls b=32 head
(B2), the six fused tails of a cls b=32 forward (B3), the seven backward
calls of a cls b=12 step and the fourteen of an inv b=16-a-leg step (B9);
each path's sum is printed after its shapes. One JSON line a record, all
of them in chiprun_out/grouped_conv_variants.json. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from .ops.kernels import build
from .ops.kernels import grouped_conv as gc

OUT = os.path.join(build.BUILD_DIR, 'grouped_conv_variants')
ROOT = os.path.dirname(build.BUILD_DIR)
# variant -> (text in the source, its replacement), or None for the source
VARIANTS = {
    'built': None,
    'no_stores': (
        'store_tile<NT>(out, ot, G::OS, BM, n0, N,',
        'if (acc[0][0][0] == 12345.f) store_tile<NT>(out, ot, G::OS, BM, '
        'n0, N,'),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier tree's dW entry: x, dout, ws, dW, rows, c, d, splits, bf16,
# stream
PARENT_DW = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]

# path -> [(shape tag, calls on the path, (rows, c, d) or (b, p, c, d))]
PATHS = {
    'B2 cls b=32 forward': ('forward', [('head', 1, (122880, 256, 256))]),
    'B3 cls b=32 forward': ('tail', [
        ('L1', 1, (32, 512, 64, 64)), ('L2', 1, (32, 256, 64, 128)),
        ('L3', 1, (32, 256, 128, 128)), ('L4', 1, (32, 128, 128, 256)),
        ('L5', 1, (32, 128, 256, 256)), ('L6', 1, (32, 64, 256, 256))]),
    'B9 cls b=12 step': ('backward', [
        ('head, L6', 2, (46080, 256, 256)), ('L5', 1, (92160, 256, 256)),
        ('L4', 1, (92160, 128, 256)), ('L3', 1, (184320, 128, 128)),
        ('L2', 1, (184320, 64, 128)), ('L1', 1, (368640, 64, 64))]),
    'B9 inv b=16 step': ('backward', [
        ('B3L0, B3L1', 4, (61440, 128, 128)), ('B2L1', 2, (122880, 128, 128)),
        ('B2L0', 2, (122880, 64, 128)), ('B1L1', 2, (245760, 64, 64)),
        ('B1L0', 2, (245760, 32, 64)), ('B0L1', 2, (491520, 32, 32))]),
}


def _build(name, csrc, sub):
    """Start nvcc on grouped_conv.cu of ``csrc`` with the substitution
    ``sub``; (process, library path)."""
    return build.compile_alone(csrc, 'grouped_conv.cu',
                               os.path.join(OUT, name), sub)


def _load(so, parent):
    lib = ctypes.CDLL(so)
    sigs = {k: build.SIGNATURES[k]
            for k in ('epn_grouped_conv', 'epn_grouped_conv_tail')}
    if parent:
        sigs['epn_grouped_conv_bwd_w'] = PARENT_DW
    else:
        sigs['epn_grouped_conv_bwd'] = build.SIGNATURES['epn_grouped_conv_bwd']
    for k, argtypes in sigs.items():
        getattr(lib, k).argtypes = argtypes
        getattr(lib, k).restype = ctypes.c_int
    return lib


def _launch(lib, name, *args):
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent-csrc', default=None,
                    help="an earlier tree's csrc/ directory, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('grouped_conv_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_abba, time_ms

    builds = {n: (build.CSRC_DIR, sub) for n, sub in VARIANTS.items()}
    if args.parent_csrc:
        builds['parent'] = (os.path.abspath(args.parent_csrc), None)
    procs = {n: _build(n, csrc, sub) for n, (csrc, sub) in builds.items()}
    libs = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {n}:\n{log}')
        libs[n] = _load(so, n == 'parent')
    dev, bf = torch.device('cuda'), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g)
                * scale).to(dtype)

    def stream():
        return torch.cuda.current_stream().cuda_stream
    card = torch.cuda.get_device_name(0)
    lines = []

    def emit(rec):
        rec['card'] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def forward(lib, x, W, bias, out, rows, c, d):
        return lambda: _launch(lib, 'epn_grouped_conv', x.data_ptr(),
                               W.data_ptr(), bias.data_ptr(), out.data_ptr(),
                               rows, c, d, 1, stream())

    def shape_forward(rows, c, d):
        x, W = rnd(rows, c), rnd(c, d, scale=0.1)
        bias = rnd(d, dtype=torch.float32)
        b2 = bias.to(bf)
        out = torch.empty(rows, d, device=dev, dtype=bf)
        rec = {'library_ms': time_ms(lambda: torch.addmm(b2, x, W)),
               'no_stores_ms': time_ms(forward(libs['no_stores'], x, W, bias,
                                               out, rows, c, d))}
        return rec, {n: forward(libs[n], x, W, bias, out, rows, c, d)
                     for n in ('built', 'parent') if n in libs}

    def shape_tail(b, p, c, d):
        na = 60
        rows, L = b * p * na, na * d
        x, W, y = rnd(rows, c), rnd(c, d, scale=0.1), rnd(rows, d)
        bias = rnd(d, dtype=torch.float32)
        ssk = torch.stack([rnd(1, L, dtype=torch.float32).abs() + 0.5,
                           rnd(1, L, dtype=torch.float32)], 1).contiguous()
        ssm = torch.stack([rnd(b, L, dtype=torch.float32).abs() + 0.5,
                           rnd(b, L, dtype=torch.float32)], 1).contiguous()
        out = torch.empty(rows, d, device=dev, dtype=bf)

        def tail(lib):
            return lambda: _launch(
                lib, 'epn_grouped_conv_tail', x.data_ptr(), W.data_ptr(),
                bias.data_ptr(), ssk.data_ptr(), y.data_ptr(), ssm.data_ptr(),
                out.data_ptr(), b, p, na, c, d, 0, 2 * L, build.LEAKY_SLOPE,
                1, stream())
        rec = {'no_stores_ms': time_ms(tail(libs['no_stores']))}
        return rec, {n: tail(libs[n]) for n in ('built', 'parent')
                     if n in libs}

    def shape_backward(rows, c, d):
        x, W, dout = rnd(rows, c), rnd(c, d, scale=0.1), rnd(rows, d)
        dx = torch.empty(rows, c, device=dev, dtype=bf)
        splits = gc._bwd_splits(rows, c, d, 1)
        ws = torch.empty(splits, c + 1, d, device=dev)
        dwb = torch.empty(c + 1, d, device=dev)

        def bwd(parts):
            return lambda: _launch(
                libs['built'], 'epn_grouped_conv_bwd', x.data_ptr(),
                W.data_ptr(), dout.data_ptr(), dx.data_ptr(), ws.data_ptr(),
                dwb.data_ptr(), rows, c, d, splits, parts, 1, stream())
        dx_alone, dw_alone = bwd(1), bwd(2)

        def two_launches():
            dx_alone()
            dw_alone()
        rec = {'library_ms': time_ms(lambda: torch.mm(dout, W.t()))
               + time_ms(lambda: torch.mm(x.t(), dout)),
               'two_launch_ms': time_ms(two_launches)}
        fns = {'built': bwd(3)}
        if 'parent' in libs:
            # the earlier wrappers: dx on W transposed (a copy), dW by
            # 128 x BN tiles over 16-row slices, dbias as a widened sum
            bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
            psplits = build.n_splits(-(-c // 128) * (d // bn),
                                     -(-rows // 16))
            pws = torch.empty(psplits, c, d, device=dev)
            pdw = torch.empty(c, d, device=dev)
            lib = libs['parent']

            def parent():
                Wt = W.t().contiguous()
                _launch(lib, 'epn_grouped_conv', dout.data_ptr(),
                        Wt.data_ptr(), 0, dx.data_ptr(), rows, d, c, 1,
                        stream())
                _launch(lib, 'epn_grouped_conv_bwd_w', x.data_ptr(),
                        dout.data_ptr(), pws.data_ptr(), pdw.data_ptr(),
                        rows, c, d, psplits, 1, stream())
                build.widen(dout).sum(dim=0)
            fns['parent'] = parent
        return rec, fns

    shape_fn = {'forward': shape_forward, 'tail': shape_tail,
                'backward': shape_backward}
    for path, (kind, shapes) in PATHS.items():
        total = {}
        for tag, calls, shape in shapes:
            rec, fns = shape_fn[kind](*shape)
            if 'parent' in fns:
                rec['parent_ms'], rec['built_ms'] = time_abba(
                    fns['parent'], fns['built'])
            else:
                rec['built_ms'] = time_ms(fns['built'])
            emit({'path': path, 'shape': tag, 'calls': calls,
                  'dims': list(shape), **rec})
            for k, v in rec.items():
                total[k] = total.get(k, 0.0) + calls * v
            torch.cuda.empty_cache()
        emit({'path': path, 'sum_over_path': True, **total})
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'grouped_conv_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


if __name__ == '__main__':
    main()
