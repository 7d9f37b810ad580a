"""The readings that set the fp32 gates of the data-parallel checks
(``parallel.dryrun.compare``, ``FP32_GATES``, ``DEGENERATE_ERR``): each full-width fp32 step of ``parallel.dryrun`` (cls
b=12, inv 16 patches a leg, reg b=8 pairs) against one process's step on
the same global batch, on the card.

  python -m epn_pointcloud_tpu_torch.dp_variants [--out DIR]
      [--device cuda:0] [--steps cls_fp32,inv_fp32,reg_fp32]

What the reduction order alone moves (the gates must pass these):
  repeat      one process's step again (the fused dTable's atomics);
  swapped     one process on the batch with its halves swapped;
  rolled      one process on the batch rolled by a quarter;
  world2      two gloo ranks on this device, each on its half: the path
              under test.
Faults (the gates must catch these):
  halves      the mean of one process's steps on each half: norm
              statistics and mined negatives over a rank's half (reg has
              neither, so its ``halves`` is sound);
  local_stats two ranks whose BatchNorm takes its own half's statistics.
And the form of the fp32 global statistics that the Welford merge
replaced, for cls:
  sum_stats   two ranks whose global mean is the all-reduced sum / n and
              variance the all-reduced centered squares / n.

Each reading is one JSON line (``dryrun.leaf_gaps``, the degenerate
leaves marked by one process's float64 step on the plain path: the loss's
relative difference, the lowest leaf cosine, the largest max error of a
leaf's max, the degenerate leaves' largest difference in units of the
step's largest gradient) with cls's block-0 skip norm weight (its
BatchNorm normalizes a field constant over the batch, so its gradient is
0 in exact arithmetic) and whether ``dryrun.fp32_gates_hold``; then, per
step, every real leaf's worst cosine and error over the sound readings and
its best over the faults, and with --json PATH every leaf's readings. The
rank processes run this module with ``--rank VARIANT`` before dryrun's own
arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.nn.functional as F

CONSTANT_LEAF = 'grad/backbone.0.blocks.0.norm.weight'
MODULE = 'epn_pointcloud_tpu_torch.dp_variants'


def _install(variant: str) -> None:
    """BatchNorm's fp32 train path over the data group as ``variant``."""
    from .nn import layers
    from .ops.kernels.build import widen
    from .parallel import collectives, mesh

    def local_stats(self, x):
        c = x.shape[-1]
        return F.batch_norm(x.reshape(-1, c), self.running_mean,
                            self.running_var, self.weight, self.bias,
                            training=True, momentum=self.momentum,
                            eps=self.eps).reshape(x.shape)

    def sum_stats(self, x):
        c = x.shape[-1]
        xf = widen(x).reshape(-1, c)
        n = xf.shape[0] * mesh.data_world()
        mean = collectives.all_reduce_sum(xf.sum(0), mesh.data_group()) / n
        var = collectives.all_reduce_sum(((xf - mean) ** 2).sum(0),
                                         mesh.data_group()) / n
        self._move_running(mean, var, n)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return y.reshape(x.shape).to(x.dtype)
    layers.BatchNorm._global_forward = {'local_stats': local_stats,
                                        'sum_stats': sum_stats}[variant]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ['--rank']:
        from .parallel import dryrun
        _install(argv[1])
        return dryrun.main(argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join('build', 'dp_variants'))
    ap.add_argument('--device', default='cuda:0')
    ap.add_argument('--steps', default='cls_fp32,inv_fp32,reg_fp32')
    ap.add_argument('--size', default='full')
    ap.add_argument('--timeout', type=float, default=300)
    ap.add_argument('--json', default=None)
    args = ap.parse_args(argv)
    from .parallel import dryrun
    device = torch.device(args.device)
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    tags = args.steps.split(',')
    local = os.path.join(args.out, 'one')

    def ranks(name, steps, variant=None):
        out = os.path.join(args.out, name)
        os.makedirs(out)
        rank_argv = ['--out', out, '--size', args.size, '--backend', 'gloo',
                     '--device', args.device, '--steps', ','.join(steps)]
        if variant:
            rank_argv = ['--rank', variant] + rank_argv
        dryrun.launch(2, rank_argv, args.timeout, os.path.join(out, 'logs'),
                      module=MODULE if variant else dryrun.MODULE)
        return {t: dict(np.load(os.path.join(out, f'{t}_rank0.npz')))
                for t in steps}

    world = {'world2': ranks('world2', tags)}
    if 'cls_fp32' in tags:
        for v in ('local_stats', 'sum_stats'):
            world[v] = ranks(v, ['cls_fp32'], v)
    readings, per_leaf = [], {}
    sound_names = ('repeat', 'repeat_2', 'swapped', 'rolled', 'world2')
    for tag in tags:
        kind = dryrun.STEPS[tag][0]
        batch = dryrun.global_batch(kind, args.size)
        f64 = dryrun.f64_grads(kind, args.size, device, local)

        def step(b=None):
            return dryrun.run_step(tag, args.size, device, local, batch=b)
        want = step()
        rolled = {k: np.roll(v, v.shape[dryrun.batch_axis(kind)] // 4,
                             dryrun.batch_axis(kind))
                  for k, v in batch.items()}
        runs = {'repeat': step(), 'repeat_2': step(),
                'swapped': step(dryrun.swap_halves(kind, batch)),
                'rolled': step(rolled),
                'halves': dryrun.mean_of([step(h) for h in
                                          dryrun.halves(kind, batch)])}
        runs.update({v: res[tag] for v, res in world.items() if tag in res})
        leaf = per_leaf[tag] = {}
        for name, got in runs.items():
            gaps = dryrun.leaf_gaps(got, want, f64)
            for k, cos in gaps.pop('cos').items():
                leaf.setdefault(k, {})[name] = (cos, gaps['err'][k])
            gaps.pop('err')
            row = {'step': tag, 'reading': name, **gaps,
                   'gates_hold': dryrun.fp32_gates_hold(kind, gaps)}
            if CONSTANT_LEAF in want:
                row['constant_leaf_max_abs'] = [
                    float(np.abs(got[CONSTANT_LEAF]).max()),
                    float(np.abs(want[CONSTANT_LEAF]).max())]
            readings.append(row)
            print('[dp-variants] ' + json.dumps(row), flush=True)
        fault_names = [n for n in runs if n not in sound_names
                       and n != 'sum_stats' and not (
                           n == 'halves' and kind == 'reg')]
        for k, rs in leaf.items():
            snd = [rs[n] for n in rs if n in sound_names or (
                n == 'halves' and kind == 'reg')]
            flt = [rs[n] for n in fault_names if n in rs]
            print('[dp-variants] ' + json.dumps({
                'step': tag, 'leaf': k, 'f64_of_top': f64[k] / max(
                    f64.values()),
                'sound_min_cos': min(c for c, _ in snd),
                'sound_max_err': max(e for _, e in snd),
                'fault_max_cos': max((c for c, _ in flt), default=None),
                'fault_min_err': min((e for _, e in flt), default=None)}),
                flush=True)
    sound = [r for r in readings if r['reading'] in (
        'repeat', 'repeat_2', 'swapped', 'rolled', 'world2')
        or (r['reading'] == 'halves' and r['step'].startswith('reg'))]
    faults = [r for r in readings if r['reading'] == 'local_stats' or (
        r['reading'] == 'halves' and not r['step'].startswith('reg'))]
    print('[dp-variants] ' + json.dumps({
        'gates': dryrun.FP32_GATES, 'degenerate': dryrun.DEGENERATE_ERR,
        'sound_hold': all(r['gates_hold'] for r in sound),
        'faults_caught': not any(r['gates_hold'] for r in faults)}),
        flush=True)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump({'readings': readings, 'per_leaf': per_leaf}, f)
    shutil.rmtree(args.out, ignore_errors=True)


if __name__ == '__main__':
    main()
