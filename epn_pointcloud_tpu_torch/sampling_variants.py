"""Where furthest point sampling (``fps_reg_kernel`` in csrc/fps.cu) and
the ball query (``ball_query_warp_kernel`` in csrc/ball_query.cu) spend
their time, on the card: each kernel as built beside builds with one part
changed or taken out, on the inputs the models give them, each build timed
by the device timer (``chip_smoke.device_ms``: back-to-back calls in a CUDA
graph) in turn and again in the reverse order.

  python -m epn_pointcloud_tpu_torch.sampling_variants [--parent-csrc DIR]

It imports ``chip_smoke`` from the repository root. Each build is the
source compiled alone (nvcc, sm_90a) under build/sampling_variants/ with
the text substitutions below (which fail loudly when the source no longer
holds the text). fps (``epn_fps_reg``):
  fps_built      the source as it is (512 threads a cloud);
  fps_t128, fps_t256, fps_t1024
                 128, 256 or 1024 threads a cloud (8, 4 or 1 points a
                 thread at 1024 points);
  fps_no_dist    the distance to the last pick replaced by one subtraction:
                 the argmax and barrier loop alone, the floor of the
                 sequential loop; wrong;
and beside them this tree's shared-memory kernel (``fps_smem``,
``epn_fps``). The ball query (``epn_ball_query_warp``):
  bq_built       the source as it is (a warp a query, 128 points a step,
                 the support read through L1);
  bq_u1, bq_u2, bq_u8
                 32, 64 or 256 points a step;
  bq_staged      the block stages the support through shared memory;
  bq_l16, bq_l8  16 or 8 lanes a query (2 or 4 queries a warp);
  bq_l16_staged, bq_l8_staged
                 the same, staged;
and beside them this tree's thread-a-query kernel (``bq_thread``,
``epn_ball_query``). With --parent-csrc DIR (an earlier tree's csrc/) also
that tree's epn_fps and epn_ball_query (``fps_parent``, ``bq_parent``).
Every build that keeps the arithmetic is held index-equal to the plain
version (``equal``).

Inputs: the fps and ball query calls of a cls_so3net_pn forward at b=32
(serving) and b=12 (the train step's batch) on synthetic clouds, and of an
inv_so3net_pn forward at b=16 (a triplet step's leg) and b=48 (serving) on
patches of a dense synthetic 3DMatch tree; seeded weights, captured on the
plain path. Output: JSON lines, and all of them in
chiprun_out/sampling_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from .ops import kernels
from .ops.kernels import build

OUT = os.path.join(build.BUILD_DIR, 'sampling_variants')
ROOT = os.path.dirname(build.BUILD_DIR)

_THREADS = 'constexpr int kRegThreads = 512;'
_DIST = 'return sq3(__fsub_rn(x, x1), __fsub_rn(y, y1), __fsub_rn(z, z1));'
_LANES = 'constexpr int kLanes = 32;'
_UNROLL = 'constexpr int kUnroll = 4;'
_STAGED = ('constexpr bool kStage = false;', 'constexpr bool kStage = true;')


def _set(text, value):
    """The substitution of the constant declared in ``text`` by ``value``."""
    return (text, text.rsplit('= ', 1)[0] + f'= {value};')


FPS_VARIANTS = {
    'fps_built': None,
    'fps_t128': _set(_THREADS, 128),
    'fps_t256': _set(_THREADS, 256),
    'fps_t1024': _set(_THREADS, 1024),
    'fps_no_dist': (_DIST, 'return __fsub_rn(x, x1);'),
}
BQ_VARIANTS = {
    'bq_built': None,
    'bq_u1': _set(_UNROLL, 1),
    'bq_u2': _set(_UNROLL, 2),
    'bq_u8': _set(_UNROLL, 8),
    'bq_staged': _STAGED,
    'bq_l16': _set(_LANES, 16),
    'bq_l8': _set(_LANES, 8),
    'bq_l16_staged': [_set(_LANES, 16), _STAGED],
    'bq_l8_staged': [_set(_LANES, 8), _STAGED],
}
INEXACT = ('fps_no_dist',)


def model_calls(device):
    """{(model, batch): [(name, args)]}: the fps and ball query calls of
    the four forwards (plain path)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from . import models
    out = {}
    cls = models.build_model_from(cs.full_opt(), seed=cs.SEED).to(
        device).eval()
    for b in (cs.BATCH, cs.TRAIN_BATCH):
        x = torch.from_numpy(cs.synthetic_batch(b, cs.N_POINTS, cs.SEED)).to(
            device)
        out[('cls', b)] = _capture(cs, lambda: cls(x))
    del cls
    inv = cs.inv_model(device).eval()
    src, tgt = cs.inv_legs(cs.inv_tree(), device, items=(0, 1))
    for b in (cs.INV_BATCH, cs.INV_DESC_BATCH):
        x = torch.cat([src, tgt])[:b].contiguous()
        out[('inv', b)] = _capture(cs, lambda: inv(x))
    return out


def _capture(cs, forward):
    """The forward's fps and ball query calls, as (wrapper name, args):
    the plain path calls the plain versions, which take the same
    arguments."""
    with torch.no_grad(), kernels.plain():
        calls = cs.capture_calls(('fps_plain', 'ball_query_plain'), forward)
    torch.cuda.empty_cache()
    return [(name[:-len('_plain')], args) for name, args in calls]


def _load(procs):
    """{build: its library} once every nvcc is done."""
    libs, failed = {}, {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            failed[n] = log
            continue
        libs[n] = ctypes.CDLL(so)
    if failed:
        raise RuntimeError('nvcc failed on ' + ''.join(
            f'{n}:\n{log}\n' for n, log in failed.items()))
    return libs


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def parent_entry(lib, name, source_dir):
    """The C entry ``name`` of an earlier tree's library, built from the
    sources in ``source_dir`` (``build.compile_alone``), with this tree's
    signature; an earlier ball query entry, which predates its ``ref_fill``
    argument, takes this tree's arguments and drops it (and refuses a call
    that sets it; its ``has_ref_fill`` is False)."""
    if name in ('epn_ball_query', 'epn_ball_query_warp'):
        with open(os.path.join(source_dir, 'ball_query.cu')) as f:
            has_ref_fill = 'ref_fill' in f.read()
        if not has_ref_fill:
            fn = getattr(lib, name)
            sig = build.SIGNATURES[name]
            fn.argtypes, fn.restype = sig[:-2] + sig[-1:], ctypes.c_int

            def call(*args):
                if args[-2]:
                    raise ValueError(f'{name} of {source_dir} has no '
                                     f'ref_fill')
                return fn(*args[:-2], args[-1])
            call.has_ref_fill = False
            return call
    return _entry(lib, name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent-csrc', default=None,
                    help="an earlier tree's csrc/: its epn_fps and "
                    'epn_ball_query timed beside the builds')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('sampling_variants: needs a CUDA device')
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms
    procs = {n: build.compile_alone(build.CSRC_DIR, 'fps.cu',
                                    os.path.join(OUT, n), sub)
             for n, sub in FPS_VARIANTS.items()}
    procs.update({n: build.compile_alone(build.CSRC_DIR, 'ball_query.cu',
                                         os.path.join(OUT, n), sub)
                  for n, sub in BQ_VARIANTS.items()})
    if args.parent_csrc:
        for n, src in (('fps_parent', 'fps.cu'),
                       ('bq_parent', 'ball_query.cu')):
            procs[n] = build.compile_alone(os.path.abspath(args.parent_csrc),
                                           src, os.path.join(OUT, n))
    libs = _load(procs)
    fns = {'fps': {n: _entry(libs[n], 'epn_fps_reg') for n in FPS_VARIANTS},
           'ball_query': {n: _entry(libs[n], 'epn_ball_query_warp')
                          for n in BQ_VARIANTS}}
    fns['fps']['fps_smem'] = _entry(libs['fps_built'], 'epn_fps')
    fns['ball_query']['bq_thread'] = _entry(libs['bq_built'],
                                            'epn_ball_query')
    if args.parent_csrc:
        fns['fps']['fps_parent'] = _entry(libs['fps_parent'], 'epn_fps')
        fns['ball_query']['bq_parent'] = parent_entry(
            libs['bq_parent'], 'epn_ball_query',
            os.path.dirname(procs['bq_parent'][1]))
    dev = torch.device('cuda')
    card = torch.cuda.get_device_name(0)
    lines = []
    for (model, b), calls in model_calls(dev).items():
        total = {}
        for i, (name, cargs) in enumerate(calls):
            rec = _time_call(name, cargs, fns[name], device_ms)
            for n, r in rec.items():
                total.setdefault(name, {}).setdefault(n, 0.0)
                total[name][n] += r['ms']
            lines.append({'model': model, 'batch': b, 'call': i,
                          'kernel': name, 'shape': _shape(name, cargs),
                          'variants': rec, 'card': card})
            print(json.dumps(lines[-1]), flush=True)
        lines.append({'model': model, 'batch': b, 'sum_over_calls': True,
                      'ms': total, 'card': card})
        print(json.dumps(lines[-1]), flush=True)
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'sampling_variants.json'), 'w') as f:
        json.dump(lines, f, indent=1)


def _shape(name, args):
    if name == 'fps':
        return f'xyz {tuple(args[0].shape)} -> {args[1]}'
    return (f'query {tuple(args[0].shape)} support {tuple(args[1].shape)} '
            f'ns={args[3]} r={args[2]:.4f}')


def _time_call(name, args, fns, device_ms):
    """{build: {'ms', 'equal'}} of one captured call: each build timed in
    turn, then again in the reverse order (the mean of the two)."""
    if name == 'fps':
        x, n_sample, eps = args
        ins, tail = (x.data_ptr(),), (x.shape[0], x.shape[1], n_sample,
                                      float(eps))
        want = kernels.fps.fps_plain(x, n_sample, eps)
    else:
        x, support, radius, n_sample, ref_fill = args
        ins = (x.data_ptr(), support.data_ptr())
        tail = (x.shape[0], x.shape[1], support.shape[1], n_sample,
                kernels.ball_query._r2_f32(radius), int(ref_fill))
        want = kernels.ball_query.ball_query_plain(x, support, radius,
                                                   n_sample, ref_fill)
    out = torch.empty_like(want)
    ptrs = ins + (out.data_ptr(),) + tail

    def call(n):
        fn = fns[n]

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
        if n not in INEXACT:
            out.fill_(-1)
            call(n)()
            torch.cuda.synchronize()
            rec[n]['equal'] = torch.equal(out, want)
    return rec


if __name__ == '__main__':
    main()
