"""Where the ones conv (``ones_conv_kernel`` in csrc/ones_conv.cu) spends
its time, on the card: the kernel as built beside builds with one part
changed or taken out, on the inputs the models give it, each build timed by
the device timer (``chip_smoke.device_ms``: back-to-back calls in a CUDA
graph) in turn and again in the reverse order.

  python -m epn_pointcloud_tpu_torch.ones_conv_variants [--parent-csrc DIR]

It imports ``chip_smoke`` from the repository root. Each build is
csrc/ones_conv.cu compiled alone (nvcc, sm_90a) under
build/ones_conv_variants/ with the text substitutions below (which fail
loudly when the source no longer holds the text):
  built          the source as it is (5 lanes a thread, 288 threads at 60 x
                 24 lanes, 4 points a block, 4 partial sums a lane, the
                 neighbor loop over 4 at a time unrolled by 2);
  parts_1        one partial sum a lane (the neighbors in one chain, as
                 built before the partial sums);
  lanes_3, lanes_15
                 3 or 15 lanes a thread (480 or 96 threads);
  pts_1, pts_2, pts_8
                 1, 2 or 8 points a block;
  unroll_1       the neighbor loop not unrolled (4 neighbors a pass);
  relu_max       the relu as fmaxf after an unclamped FFMA (one more
                 instruction a weight);
and, whose output is wrong and only whose time counts:
  no_stores      F is not stored.
With --also A+B,... also the builds that apply the named builds'
substitutions together. With --parent-csrc DIR (an earlier tree's csrc/)
also that tree's epn_ones_conv (``parent``). For every build whose output
is right, its
normwise error against ``ones_conv_plain`` (``rel``), and in fp32 its
float64 error over the plain fp32 version's (``f64_ratio``) and whether it
equals the built kernel bit for bit (``equal_built``).

Inputs: the ones conv calls of a cls_so3net_pn forward at b=32 (serving),
of an inv_so3net_pn forward at b=16 (a triplet step's leg) and b=48
(serving) and of a reg_so3net forward at b=8 pairs (16 clouds) on
synthetic clouds, patches and alignment pairs; seeded weights, captured on
the plain path; each in fp32 and in bf16. Output: JSON lines, with each build's
registers and spills (nvcc's -Xptxas -v), all of them in
chiprun_out/ones_conv_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from .inter_bwd_variants import ptxas_usage
from .intra_conv_variants import _rel
from .ops import kernels
from .ops.kernels import build
from .sampling_variants import _entry, _set

OUT = os.path.join(build.BUILD_DIR, 'ones_conv_variants')
ROOT = os.path.dirname(build.BUILD_DIR)

_LANES = 'constexpr int kLanes = 5;'
_POINTS = 'constexpr int kPoints = 4;'
_UNROLL = '#pragma unroll 2\n      for (int n = 0; n < nnp; n += kParts) {'
_WEIGHT = ('part[q][j] += fma_sat(v.z, az[j], fmaf(v.y, ay[j], '
           'fmaf(v.x, ax[j], t)));')
VARIANTS = {
    'built': None,
    'lanes_3': _set(_LANES, 3),
    'lanes_15': _set(_LANES, 15),
    'pts_1': _set(_POINTS, 1),
    'pts_2': _set(_POINTS, 2),
    'pts_8': _set(_POINTS, 8),
    'unroll_1': (_UNROLL, _UNROLL.replace('unroll 2', 'unroll 1')),
    'relu_max': (_WEIGHT, 'part[q][j] += fmaxf(fmaf(v.z, az[j], fmaf(v.y, '
                 'ay[j], fmaf(v.x, ax[j], t))), 0.f);'),
    'parts_1': _set('constexpr int kParts = 4;', 1),
    # a store that never runs but keeps the sums live (they are >= 0)
    'no_stores': ('if (l0 + tid + j * nt < L) {', 'if (acc[j] < 0.f) {'),
}
INEXACT = ('no_stores',)


def model_calls(device):
    """{(model, batch): [ones conv args]}: the calls of the three forwards
    (plain path)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from . import models
    out = {}
    cls = models.build_model_from(cs.full_opt(), seed=cs.SEED).to(
        device).eval()
    x = torch.from_numpy(cs.synthetic_batch(cs.BATCH, cs.N_POINTS,
                                            cs.SEED)).to(device)
    out[('cls', cs.BATCH)] = _capture(cs, lambda: cls(x))
    del cls
    inv = cs.inv_model(device).eval()
    src, tgt = cs.inv_legs(cs.inv_tree(), device, items=(0, 1))
    for b in (cs.INV_BATCH, cs.INV_DESC_BATCH):
        x = torch.cat([src, tgt])[:b].contiguous()
        out[('inv', b)] = _capture(cs, lambda: inv(x))
    del inv
    reg = cs.reg_model(device).eval()
    pc = cs.reg_batch(cs.reg_tree(), device)[0]
    out[('reg', 2 * cs.REG_BATCH)] = _capture(cs, lambda: reg(pc))
    return out


def _capture(cs, forward):
    with torch.no_grad(), kernels.plain():
        calls = cs.capture_calls(('ones_conv_plain',), forward)
    torch.cuda.empty_cache()
    return [args[:4] for _, args in calls]


def _pairs(sub):
    """A build's substitutions as a list of (text, replacement)."""
    return [sub] if isinstance(sub[0], str) else list(sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent-csrc', default=None,
                    help="an earlier tree's csrc/: its epn_ones_conv timed "
                    'beside the builds')
    ap.add_argument('--also', default='',
                    help='more builds, comma-separated, each the named '
                    "builds' substitutions together (lanes_15+pts_2)")
    args = ap.parse_args(argv)
    builds = dict(VARIANTS)
    for combo in filter(None, args.also.split(',')):
        builds[combo] = [pair for n in combo.split('+')
                         for pair in _pairs(VARIANTS[n])]
    if not torch.cuda.is_available():
        raise SystemExit('ones_conv_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms
    procs = {n: build.compile_alone(build.CSRC_DIR, 'ones_conv.cu',
                                    os.path.join(OUT, n.replace('+', '-')),
                                    sub)
             for n, sub in builds.items()}
    if args.parent_csrc:
        procs['parent'] = build.compile_alone(
            os.path.abspath(args.parent_csrc), 'ones_conv.cu',
            os.path.join(OUT, 'parent'))
    fns, regs = {}, {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on {n}:\n{log}')
        regs[n] = ptxas_usage(log, 'ones_conv_kernel')
        fns[n] = _entry(ctypes.CDLL(so), 'epn_ones_conv')
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    lines = [{'registers': regs, 'card': card}]
    print(json.dumps(lines[-1]), flush=True)
    for (model, b), calls in model_calls(dev).items():
        for i, cargs in enumerate(calls):
            for dtype in (torch.float32, torch.bfloat16):
                rec = _time_call(cargs, dtype, fns, device_ms)
                lines.append({'model': model, 'batch': b, 'call': i,
                              'dtype': str(dtype).split('.')[-1],
                              'gx': list(cargs[0].shape), 'variants': rec,
                              'card': card})
                print(json.dumps(lines[-1]), flush=True)
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'ones_conv_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


def _time_call(args, dtype, fns, device_ms):
    """{build: {'ms', 'rel', 'f64_ratio', 'equal_built'}} of one captured
    call in ``dtype``: each build timed in turn, then again in the reverse
    order (the mean of the two)."""
    gx, rk, k2, sigma = args
    b, p2, nn, _ = gx.shape
    na, K = rk.shape[:2]
    plain = kernels.ones_conv.ones_conv_plain
    want = plain(gx, rk, k2, sigma, dtype)
    w64 = plain(gx.double(), rk.double(), k2.double(), sigma, torch.float64) \
        if dtype == torch.float32 else None
    outs = {n: torch.empty_like(want) for n in fns}

    def call(n):
        fn = fns[n]
        ptrs = (gx.data_ptr(), rk.data_ptr(), k2.data_ptr(),
                outs[n].data_ptr(), b, p2, nn, na, K, float(sigma),
                int(dtype == torch.bfloat16))

        def run():
            err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'{n}: CUDA error {err}')
        return run
    names = list(fns)
    rec = {n: {'ms': 0.0} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            rec[n]['ms'] += device_ms(call(n)) / 2
    for n in names:
        if any(v in INEXACT for v in n.split('+')):
            continue
        call(n)()
        torch.cuda.synchronize()
        rec[n]['rel'] = _rel(outs[n], want)
        if w64 is not None:
            rec[n]['f64_ratio'] = _rel(outs[n], w64) / max(
                _rel(want, w64), 1e-30)
        rec[n]['equal_built'] = torch.equal(outs[n], outs['built'])
    del w64
    torch.cuda.empty_cache()
    return rec


if __name__ == '__main__':
    main()
