"""Device-time profile of the eval forward, or of one train step, on the
card: cls_so3net_pn (ModelNet40), inv_so3net_pn (3DMatch descriptors) or
reg_so3net (the rotation-alignment pair model).

  python -m epn_pointcloud_tpu_torch.profile_forward [--dtype fp32 bf16] [-b 32]
  python -m epn_pointcloud_tpu_torch.profile_forward --train [--dtype bf16] \
      [-b 12]
  python -m epn_pointcloud_tpu_torch.profile_forward --model inv_so3net_pn \
      --train [--compute-dtype bf16] [-b 16]
  python -m epn_pointcloud_tpu_torch.profile_forward --model reg_so3net \
      [--train] [-b 8]

Builds the seeded full-width model (1024 points, 60 anchors, random weights)
on a synthetic cloud batch, runs two warm forwards (or train steps) in each
compute dtype (``--dtype``, or its alias ``--compute-dtype``; both by
default), then profiles one with ``torch.profiler`` (CPU and CUDA
activities). A cls train step is a forward, the attention CE loss, the
backward and Adam; an inv train step is the 3DMatch triplet step: two
legs of b patches (normalized synthetic shapes scaled to the 0.4 search
radius), the soft triplet loss, the backward and Adam; a reg forward or
step takes b alignment pairs (a normalized asymmetric airplane and its
copy under a seeded random rotation: 2b clouds in one batch), the step the
multi-task detection loss in the alignment setting. Prints, per
dtype, the device time by kernel group, the kernel launches, the host wall
of the profiled run (ending in a synchronize) and the device's idle share
(1 - device busy / wall; one stream, so busy is the sum of kernel times),
plus the ten longest kernels. Writes the tables to
``chiprun_out/profile_<forward|train>[_inv|_reg].json`` in the checkout.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import losses
from .app import config, trainer
from .data import pc as pctk
from .data import synthetic
from .models import build_model_from
from .ops import icosahedron, so3conv
from .ops.rotation import label_relative_rotation_np, rand_rotation_matrix
from .train import make_optimizer

# kernel-name substrings (all of them) -> group (first match wins); the
# W-off modes are the inter kernels' instantiations with kWOff = true (and
# the W-off F's own kernels, bf16 tensor-core and fp32 CUDA-core), B6 df
# the tensor-core intra kernel's with DF = true (its last argument); the
# backward scatter's template, tensor-core and CUDA-core kernels (with
# the latter's W and dout transposes) share a group
GROUPS = (('inter_f_mma_kernel', 'inter F (W-off) kernel'),
          ('inter_f_f32_kernel', 'inter F (W-off) kernel'),
          (('inter_conv_kernel', 'true>'), 'inter F (W-off) kernel'),
          (('inter_dtable_kernel', 'true>'), 'inter dG (W-off) kernel'),
          (('inter_bwd_mma_kernel', 'true>'), 'inter dG (W-off) kernel'),
          ('inter_bwd_mma_kernel', 'inter dTable kernel'),
          (('inter_bwd_f32_kernel', 'true>'), 'inter dG (W-off) kernel'),
          ('inter_bwd_f32_kernel', 'inter dTable kernel'),
          ('inter_bwd_wt_kernel', 'inter dTable kernel'),
          ('inter_bwd_dt_kernel', 'inter dTable kernel'),
          ('inter_conv_mma_kernel', 'inter conv kernel (bf16, tensor cores)'),
          ('inter_conv_kernel', 'inter conv kernel'),
          ('inter_fwd_f32_kernel', 'inter conv kernel'),
          ('inter_dtable_kernel', 'inter dTable kernel'),
          ('inter_dw_mma_kernel', 'inter dW kernel'),
          ('inter_dw_f32_kernel', 'inter dW kernel'),
          ('inter_dw_kernel', 'inter dW kernel'),
          (('intra_conv_mma_kernel', 'true>'), 'prenorm intra df kernel'),
          ('intra_conv_mma_kernel', 'intra conv kernel (and fp32 df)'),
          ('intra_conv_kernel', 'intra conv kernel (and fp32 df)'),
          ('intra_fwd_f32_kernel', 'intra conv kernel (and fp32 df)'),
          ('intra_df_prenorm_kernel', 'prenorm intra df kernel'),
          ('intra_dw_mma_kernel', 'intra dW kernel'),
          ('intra_dw_f32_kernel', 'intra dW kernel'),
          ('intra_dw_kernel', 'intra dW kernel'),
          ('grouped_conv_mma_kernel', 'grouped conv kernel (tail, plain)'),
          ('grouped_bwd_mma_kernel', 'grouped conv backward kernel (dx, dW, '
           'dbias)'),
          ('grouped_conv_kernel', 'grouped conv fp32 kernel (tail, plain, '
           'dx)'),
          ('grouped_dw_kernel', 'grouped conv fp32 dW kernel'),
          ('colsum_kernel', 'grouped conv fp32 dW kernel'),
          ('sum_splits_kernel', 'fixed-order partial sums'),
          ('moments_kernel', 'moments kernel'),
          ('ones_conv_kernel', 'ones conv kernel'),
          ('fps', 'fps kernel'), ('ball_query', 'ball_query kernel'),
          ('gemm', 'cuBLAS GEMM'), ('cutlass', 'cuBLAS GEMM'),
          ('xmma', 'cuBLAS GEMM'), ('reduce', 'reductions'),
          ('index', 'gathers / index'), ('gather', 'gathers / index'),
          ('elementwise', 'elementwise'), ('Memcpy', 'copies'),
          ('copy', 'copies'), ('cat', 'copies'))


def _group(name: str) -> str:
    return next((g for key, g in GROUPS
                 if all(k in name for k in ((key,) if isinstance(key, str)
                                            else key))), 'other')


def _device_us(evt) -> float:
    # renamed from *_cuda_* to *_device_* in recent torch releases
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def train_step(model, x, opt, seed):
    """One train step as the trainer takes it: forward, attention-CE loss
    ('default', margin 1) on seeded labels, backward, Adam."""
    g = torch.Generator().manual_seed(seed)
    b = x.shape[0]
    label = torch.randint(0, 40, (b,), generator=g).to(x.device)
    rlabel = torch.randint(0, 60, (b,), generator=g).to(x.device)

    def step():
        opt.zero_grad(set_to_none=True)
        pred, feat = model(x)
        losses.attention_cross_entropy(pred, label, feat, rlabel, 'default',
                                       1.0)[0].backward()
        opt.step()
    return step


def inv_train_step(model, x, opt):
    """One 3DMatch triplet step: a model call a leg (x's two halves), the
    soft triplet loss (margin 1), backward, Adam."""
    src, tgt = x.chunk(2)

    def step():
        opt.zero_grad(set_to_none=True)
        losses.triplet_batch_loss(model(src)[0], model(tgt)[0], 'soft',
                                  1.0)[0].backward()
        opt.step()
    return step


def reg_pairs(rng, b: int):
    """b alignment pairs [b, 2, 1024, 3] (the source first) and their
    targets (labels [b, 60], T [b, 3, 3], R [b, 60, 3, 3])."""
    anchors = icosahedron.get_anchors(60)
    pcs, labels, Ts, Rs = [], [], [], []
    for _ in range(b):
        pc = pctk.normalize_np(synthetic.make_asym_shape(rng, 1024).T).T
        T = rand_rotation_matrix(rng)
        R, label = label_relative_rotation_np(anchors, T)
        pcs.append(np.stack([pc @ T.T, pc]))
        labels.append(label)
        Ts.append(T)
        Rs.append(R)
    return (np.asarray(pcs, np.float32), np.stack(labels),
            np.asarray(Ts, np.float32), np.asarray(Rs, np.float32))


def reg_train_step(model, x, opt, targets):
    """One rotation step: the pair forward, the multi-task detection loss
    (alignment setting, quat), backward, Adam."""
    dev = x.device
    label, T, R = (torch.from_numpy(t).to(dev) for t in targets)
    anchors = torch.from_numpy(icosahedron.get_anchors(60)).to(dev)

    def step():
        opt.zero_grad(set_to_none=True)
        wts, y = model(x)
        losses.multi_task_detection_loss(anchors, wts, label, y, R, T,
                                         nr=4)[0].backward()
        opt.step()
    return step


def profile(model, x, dtype: str, step=None) -> dict:
    """step: the train step to profile (None: the no-grad eval forward)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    so3conv.set_compute_dtype(dtype)
    run = step or (lambda: model(x))
    try:
        with torch.set_grad_enabled(step is not None):
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
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
    ap.add_argument('--dtype', '--compute-dtype', dest='dtype', nargs='+',
                    default=['fp32', 'bf16'], choices=['fp32', 'bf16'])
    ap.add_argument('--model', default='cls_so3net_pn',
                    choices=['cls_so3net_pn', 'inv_so3net_pn', 'reg_so3net'])
    ap.add_argument('-b', '--batch', type=int, default=None,
                    help='clouds a batch (default 32; 12 with --train, the '
                         'entry point\'s training batch; inv: patches a '
                         'leg, default 16; reg: pairs, default 8)')
    ap.add_argument('--train', action='store_true',
                    help='profile one train step instead of a forward')
    ap.add_argument('--seed', type=int, default=2913)
    args = ap.parse_args(argv)
    inv, reg = args.model == 'inv_so3net_pn', args.model == 'reg_so3net'
    if args.batch is None:
        args.batch = 16 if inv else 8 if reg else 12 if args.train else 32
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward: needs a CUDA device')
    trainer.set_fp32_parity()
    dev = torch.device('cuda')
    opt = config.parse_args(['experiment', '-d', 'unused'])
    opt.model.model = args.model
    opt.model.flag = 'rotation' if reg else 'attention'
    model = build_model_from(opt, seed=args.seed).to(dev)
    model.train(args.train)
    rng = np.random.RandomState(args.seed)
    if reg:
        x, *targets = reg_pairs(rng, args.batch)
    else:
        n_clouds = 2 * args.batch if inv and args.train else args.batch
        x = np.stack([pctk.normalize_np(synthetic.make_shape(
            rng, 1024, i % 8).T).T for i in range(n_clouds)]).astype(
                np.float32)
        if inv:
            x *= opt.model.search_radius
    x = torch.from_numpy(x).to(dev)
    card = torch.cuda.get_device_name(0)
    what = 'train step' if args.train else 'forward'
    out = {'card': card, 'model': args.model, 'batch': args.batch,
           'what': what, 'profiles': []}
    for dtype in args.dtype:
        step = None
        if args.train:
            adam = make_optimizer(model.parameters(), 1e-3)
            step = (inv_train_step(model, x, adam) if inv else
                    reg_train_step(model, x, adam, targets) if reg else
                    train_step(model, x, adam, args.seed))
        r = profile(model, x, dtype, step)
        out['profiles'].append(r)
        print(f'[profile] {card} {args.model} b={args.batch} {dtype} {what}: '
              f'device {r["device_ms"]:.2f} ms in {r["launches"]} launches, '
              f'wall {r["wall_ms"]:.2f} ms, idle share '
              f'{100 * r["idle_share"]:.1f}%')
        for g, v in r['groups'].items():
            print(f'  {g:40s} {v["ms"]:9.3f} ms '
                  f'{100 * v["ms"] / r["device_ms"]:5.1f}% '
                  f'{v["launches"]:5d} launches')
        for name, ms, n in r['top']:
            print(f'  top: {ms:9.3f} ms x{n:<4d} {name[:90]}')
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    name = (f'profile_{"train" if args.train else "forward"}'
            f'{"_inv" if inv else "_reg" if reg else ""}.json')
    with open(os.path.join(out_dir, name), 'w') as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
