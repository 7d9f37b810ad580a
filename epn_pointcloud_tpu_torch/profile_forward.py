"""Device-time profile of the cls_so3net_pn eval forward on the card.

  python -m epn_pointcloud_tpu_torch.profile_forward [--dtype fp32 bf16] [-b 32]

Builds the seeded full-width model (1024 points, 60 anchors, random weights)
on a synthetic cloud batch, runs two warm forwards in each compute dtype,
then profiles one forward with ``torch.profiler`` (CPU and CUDA activities).
Prints, per dtype, the device time by kernel group summed over the forward,
the kernel launches, the host wall of the profiled forward (ending in a
synchronize) and the device's idle share (1 - device busy / wall; one
stream, so busy is the sum of kernel times), plus the ten longest kernels.
Writes the tables to ``chiprun_out/profile_forward.json`` in the checkout.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .app import config, trainer
from .data import pc as pctk
from .data import synthetic
from .models import build_model_from
from .ops import so3conv

# kernel-name substrings -> group (first match wins)
GROUPS = (('inter_conv_kernel', 'inter conv kernel'),
          ('intra_conv_kernel', 'intra conv kernel'),
          ('grouped_conv_kernel', 'grouped conv kernel (tail and plain)'),
          ('moments_kernel', 'moments kernel'),
          ('ones_conv_kernel', 'ones conv kernel'),
          ('fps', 'fps kernel'), ('ball_query', 'ball_query kernel'),
          ('gemm', 'cuBLAS GEMM'), ('cutlass', 'cuBLAS GEMM'),
          ('xmma', 'cuBLAS GEMM'), ('reduce', 'reductions'),
          ('index', 'gathers / index'), ('gather', 'gathers / index'),
          ('elementwise', 'elementwise'), ('Memcpy', 'copies'),
          ('copy', 'copies'), ('cat', 'copies'))


def _group(name: str) -> str:
    return next((g for key, g in GROUPS if key in name), 'other')


def _device_us(evt) -> float:
    # renamed from *_cuda_* to *_device_* in recent torch releases
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(model, x, dtype: str) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    so3conv.set_compute_dtype(dtype)
    try:
        with torch.no_grad():
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        so3conv.set_compute_dtype('fp32')
    kernels = [(e.key, _device_us(e) / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    busy = sum(ms for _, ms, _ in kernels)
    groups = {}
    for name, ms, n in kernels:
        g = groups.setdefault(_group(name), {'ms': 0.0, 'launches': 0})
        g['ms'] += ms
        g['launches'] += n
    return {'dtype': dtype, 'wall_ms': wall_ms, 'device_ms': busy,
            # unclamped: a negative share means busy was counted twice
            'idle_share': 1.0 - busy / wall_ms,
            'launches': sum(n for _, _, n in kernels),
            'groups': dict(sorted(groups.items(), key=lambda kv: -kv[1]['ms'])),
            'top': sorted(kernels, key=lambda k: -k[1])[:10]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--dtype', nargs='+', default=['fp32', 'bf16'],
                    choices=['fp32', 'bf16'])
    ap.add_argument('-b', '--batch', type=int, default=32)
    ap.add_argument('--seed', type=int, default=2913)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward: needs a CUDA device')
    trainer.set_fp32_parity()
    dev = torch.device('cuda')
    opt = config.parse_args(['experiment', '-d', 'unused'])
    opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
    model = build_model_from(opt, seed=args.seed).to(dev).eval()
    rng = np.random.RandomState(args.seed)
    x = np.stack([pctk.normalize_np(synthetic.make_shape(rng, 1024, i % 8).T).T
                  for i in range(args.batch)]).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    card = torch.cuda.get_device_name(0)
    out = {'card': card, 'batch': args.batch, 'profiles': []}
    for dtype in args.dtype:
        r = profile(model, x, dtype)
        out['profiles'].append(r)
        print(f'[profile] {card} b={args.batch} {dtype} forward: device '
              f'{r["device_ms"]:.2f} ms in {r["launches"]} launches, wall '
              f'{r["wall_ms"]:.2f} ms, idle share {100 * r["idle_share"]:.1f}%')
        for g, v in r['groups'].items():
            print(f'  {g:40s} {v["ms"]:9.3f} ms '
                  f'{100 * v["ms"] / r["device_ms"]:5.1f}% '
                  f'{v["launches"]:5d} launches')
        for name, ms, n in r['top']:
            print(f'  top: {ms:9.3f} ms x{n:<4d} {name[:90]}')
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'profile_forward.json'), 'w') as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
