"""One data-parallel train step of each trainer, to hold the distributed
path to one process on the same global batch.

  python -m torch.distributed.run --nproc-per-node N \\
      -m epn_pointcloud_tpu_torch.parallel.dryrun --out DIR \\
      [--steps cls_fp32,cls_bf16,inv_fp32,reg_fp32] \\
      [--size small|full] [--device cpu|cuda:K] [--backend gloo|nccl] \\
      [--weights TAG=PATH ...]

Every rank joins the group (the backend of its device unless named: gloo
lets two ranks share one card, which NCCL refuses), then for each step
builds the trainer of the step's kind (seeded alike on every rank, the
norm biases shifted off zero as the train-step checks do, or a state_dict
loaded through ``-r``), runs one step through its ``_optimize`` on its
slice of the seeded global batch (``global_batch``) and writes
DIR/<tag>_rank<R>.npz: the loss of the global batch, the all-reduced
gradients, the parameters after Adam, the buffers (BatchNorm running
statistics), and as JSON the kernels' launches and routes and the
collectives run. ``run_step`` runs one such step in this process (with
no group initialized: the single-process reference); ``launch`` starts
the ranks as subprocesses with the rendezvous environment set, with a
timeout, and raises if a rank fails.

Sizes: 'full' is the flagship (1024 points, 60 anchors, the published
widths; global batches cls 12, inv 16 patches a leg, reg 8 pairs);
'small' the CPU tests' (128 points, 20 anchors, narrow widths; 4 each).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# tag -> (kind, dtype, dropout rate); fp64 is the fp32 mode's plain path
# on a float64 model and batch (the CPU checks' exact-arithmetic stand-in)
STEPS = {'cls_fp32': ('cls', 'fp32', 0.0), 'cls_bf16': ('cls', 'bf16', 0.0),
         'cls_fp64': ('cls', 'fp64', 0.0),
         'cls_dropout': ('cls', 'fp64', 0.5),
         'inv_fp32': ('inv', 'fp32', 0.0), 'inv_fp64': ('inv', 'fp64', 0.0),
         'reg_fp32': ('reg', 'fp32', 0.0), 'reg_fp64': ('reg', 'fp64', 0.0)}
SIZES = {
    'full': {'n_points': 1024, 'kanchor': 60,
             'batch': {'cls': 12, 'inv': 16, 'reg': 8}, 'widths': {}},
    'small': {'n_points': 128, 'kanchor': 20,
              'batch': {'cls': 4, 'inv': 4, 'reg': 4},
              'widths': {'cls': dict(mlps=((32, 32), (64,)), out_mlps=(64,)),
                         'inv': dict(mlps=((32, 32), (64, 64)),
                                     out_mlps=(64, 32)),
                         'reg': dict(mlps=((32, 32), (64,)),
                                     out_mlps=(64, 32))}}}
# the steps the kernels run (fp64 takes the plain path: the CPU's)
CARD_STEPS = ('cls_fp32', 'cls_bf16', 'inv_fp32', 'reg_fp32')
SEED = 2913
# the per-leaf cosine floor of a real bf16 gradient against another bf16
# step's (chip_smoke's [bf16-train] gate)
BF16_LEAF_COS = 0.9
MODULE = 'epn_pointcloud_tpu_torch.parallel.dryrun'


def make_opt(kind: str, size: str, dtype: str, dropout: float, out: str,
             weights=None):
    """The entry point's options for ``kind`` at ``size``."""
    from ..app import config
    from .. import run_3dmatch
    sz = SIZES[size]
    opt = config.parse_args([
        'experiment', '-d', out, '--model-dir', os.path.join(out, 'runs'),
        '--experiment-id', f'dryrun_{kind}', '--input-num',
        str(sz['n_points']), '--kanchor', str(sz['kanchor']),
        '--compute-dtype', 'fp32' if dtype == 'fp64' else dtype,
        '--dropout-rate', str(dropout)]
        + (['-r', weights] if weights else []))
    b = sz['batch'][kind]
    if kind == 'cls':
        opt.model.model, opt.model.flag = 'cls_so3net_pn', 'attention'
        opt.train_loss.attention_loss_type = 'default'
        opt.batch_size = b
    elif kind == 'inv':
        opt = run_3dmatch.config_opt_3dmatch(opt)
        # the builder scales block 0's neighbors by input_num // 1024: the
        # options keep 1024 whatever the patches hold
        opt.model.input_num, opt.npt = 1024, b
    else:
        opt.model.model, opt.model.flag = 'reg_so3net', 'rotation'
        opt.batch_size = b
    return opt


def global_batch(kind: str, size: str, seed: int = SEED) -> dict:
    """The seeded global batch of ``kind`` as its loader gives it: cls
    clouds with class and anchor labels; inv one fragment pair's two legs
    of patches (in a 0.4 ball, the target leg turned by a small rotation
    and jittered); reg alignment pairs of asymmetric clouds with their
    rotations and anchor labels."""
    from ..data import pc as pctk
    from ..data import synthetic
    from ..ops import icosahedron
    from ..ops.rotation import label_relative_rotation_np
    sz = SIZES[size]
    n, b = sz['n_points'], sz['batch'][kind]
    rng = np.random.RandomState(seed)

    def cloud(i):
        return pctk.normalize_np(synthetic.make_shape(rng, n, i % 8).T).T
    if kind == 'cls':
        return {'pc': np.stack([cloud(i) for i in range(b)]).astype(
                    np.float32),
                'label': rng.randint(0, 40, b).astype(np.int64),
                'R_label': rng.randint(0, 60, b).astype(np.int64)}
    if kind == 'inv':
        src = np.stack([0.4 * cloud(i) for i in range(b)])
        tgt = np.stack([x @ pctk.rotate_point_cloud(
            None, max_degree=10, rng=rng)[1].T for x in src])
        tgt += 0.005 * rng.randn(*tgt.shape)
        return {'src': src[None].astype(np.float32),
                'tgt': tgt[None].astype(np.float32)}
    anchors = icosahedron.get_anchors(sz['kanchor'])
    pcs, Ts, Rs, labels = [], [], [], []
    for _ in range(b):
        pc = pctk.normalize_np(synthetic.make_asym_shape(rng, n).T).T
        src, T = pctk.rotate_point_cloud(pc, None, rng=rng)
        R, label = label_relative_rotation_np(anchors, T)
        pcs.append(np.stack([src, pc]))
        Ts.append(T)
        Rs.append(R)
        labels.append(label)
    return {'pc': np.stack(pcs).astype(np.float32),
            'T': np.stack(Ts).astype(np.float32),
            'R': np.stack(Rs).astype(np.float32),
            'R_label': np.stack(labels).astype(np.int64)}


def local_data(kind: str, data: dict) -> dict:
    """This rank's share of a global batch, as its loader gives it: the
    ModelNet loaders shard the batch; the 3DMatch loader hands every rank
    the fragment pair, whose patches the trainer slices."""
    from .distributed import process_slice
    if kind == 'inv':
        return data
    sl = process_slice(next(iter(data.values())).shape[0])
    return {k: v[sl] for k, v in data.items()}


def trainer_class(kind: str, widths: dict):
    """The trainer of ``kind`` with no datasets (the step is handed its
    batch) and the builder's ``widths``."""
    from .. import models
    from ..app.trainer_3dmatch import Trainer3DMatch
    from ..app.trainer_modelnet import TrainerModelNet
    from ..app.trainer_modelnet_rotation import TrainerModelNetRotation
    base = {'cls': TrainerModelNet, 'inv': Trainer3DMatch,
            'reg': TrainerModelNetRotation}[kind]

    class DryRunTrainer(base):
        def _setup_datasets(self):
            self.dataset = None

        def _setup_model(self):
            if not widths:
                return super()._setup_model()
            self.exp_name = None
            self.model = models.build_model_from(
                self.opt, seed=self.opt.seed, **widths).to(self.device)
    return DryRunTrainer


def perturb_norm_biases(model: torch.nn.Module, seed: int = 5) -> None:
    """Every norm bias shifted off zero (the train-step checks' rule: at
    init block 0's skip BatchNorm sees a constant field, and the gradients
    behind it are rounding noise)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if '.norm.' in name and name.endswith('.bias'):
                p += torch.from_numpy(0.3 * rng.randn(*p.shape).astype(
                    np.float32)).to(p.device)


def build_trainer(tag: str, size: str, device, out: str, weights=None):
    kind, dtype, dropout = STEPS[tag]
    opt = make_opt(kind, size, dtype, dropout, out, weights)
    trainer = trainer_class(kind, SIZES[size]['widths'].get(kind, {}))(
        opt, device)
    if weights is None:
        perturb_norm_biases(trainer.model)
    if dtype == 'fp64':
        trainer.model.double()
    return trainer


def one_step(trainer, tag: str, size: str, batch=None) -> dict:
    """One step of ``trainer`` on its share of ``batch`` (by default the
    seeded global batch): the loss of the global batch, the gradients,
    parameters and buffers after it (numpy, by name), the launches and
    routes of the kernels and the collectives run during it."""
    from ..ops import kernels
    from . import collectives
    kind, dtype, _ = STEPS[tag]
    if batch is None:
        batch = global_batch(kind, size)
    data = local_data(kind, batch)
    if dtype == 'fp64':
        data = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in data.items()}
    kernels.reset_counts()
    collectives.reset_counts()
    trainer._optimize(data)
    if trainer.device.type == 'cuda':
        torch.cuda.synchronize(trainer.device)
    out = {'loss': np.float64(trainer.last_loss.item())}
    for n, p in trainer.model.named_parameters():
        out[f'grad/{n}'] = p.grad.detach().cpu().numpy()
        out[f'param/{n}'] = p.detach().cpu().numpy()
    for n, b in trainer.model.named_buffers():
        out[f'buffer/{n}'] = b.detach().cpu().numpy()
    out['launches'] = json.dumps({
        'counts': kernels.counts(), 'routes': {
            'fps': dict(kernels.fps.routes),
            'ball_query': dict(kernels.ball_query.routes),
            'inter': dict(kernels.inter_conv.routes),
            'intra': dict(kernels.intra_conv.routes)},
        'collectives': dict(collectives.counts)})
    return out


def run_step(tag: str, size: str, device, out: str, weights=None,
             batch=None) -> dict:
    """The step of ``tag`` in this process (``one_step`` of a new trainer
    on ``batch``), under the process group if one is initialized; the
    compute dtype back to fp32 after."""
    from ..ops import so3conv
    try:
        trainer = build_trainer(tag, size, device, out, weights)
        res = one_step(trainer, tag, size, batch)
        trainer.logger.close()
    finally:
        so3conv.set_compute_dtype('fp32')
    return res


def leaves(res: dict, prefixes) -> dict:
    """The entries of a step's results under ``prefixes`` ('grad/', ...)."""
    return {k: v for k, v in res.items() if k.startswith(prefixes)}


@contextlib.contextmanager
def recording_grad_reduce():
    """Inside the block each ``mesh.all_reduce_grads`` call keeps the
    gradients it was handed and the ones it left (clones in parameter
    order): ``rec['before']``, ``rec['after']``."""
    from . import mesh
    real, rec = mesh.all_reduce_grads, {}

    def spy(module, group):
        rec['before'] = [p.grad.clone() for p in module.parameters()]
        real(module, group)
        rec['after'] = [p.grad.clone() for p in module.parameters()]
    mesh.all_reduce_grads = spy
    try:
        yield rec
    finally:
        mesh.all_reduce_grads = real


def f64_grads(kind: str, size: str, device, out: str) -> dict:
    """Each leaf's max |gradient| in one process's step of ``kind`` in
    float64 on the plain path (the exact-arithmetic stand-in) on a quarter
    of the global batch (at least 2 samples; the full-width inv step's
    plain float64 activations outgrow the card): it marks the leaves whose
    gradient is mathematically ~0 (``leaf_gaps``), which the model's
    structure decides, not the batch."""
    import gc
    from ..ops import kernels
    batch = global_batch(kind, size)
    axis = batch_axis(kind)
    rows = max(2, next(iter(batch.values())).shape[axis] // 4)
    with kernels.plain():
        res = run_step(f'{kind}_fp64', size, device, out, batch={
            k: np.take(v, range(rows), axis) for k, v in batch.items()})
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    return {k: float(np.abs(v).max())
            for k, v in leaves(res, ('grad/',)).items()}


def check_group_of_one(trainer, tag: str, size: str, init: dict,
                       want: dict, f64: dict) -> dict:
    """The step of ``trainer``, built under a process group of one rank,
    against ``want``, the step of a trainer with no group from the same
    seed (``init``: that trainer's parameters before its step). Bitwise:
    the weights after the broadcast, the loss, the running statistics, the
    gradients the all-reduce leaves (its input divided by 1) and the
    parameters after Adam (Adam on those gradients with no group). The
    gradients themselves are held to ``want``'s as one process's step run
    again is (``REPEAT_ERR``, ``DEGENERATE_ERR``; ``f64``: ``f64_grads``):
    the fused dTable kernels add into the table with atomics, whose order,
    and so whose last bits, change from run to run. Returns the results and
    the gradients' ``leaf_gaps``; raises naming what differs."""
    from .. import train
    names = [n for n, _ in trainer.model.named_parameters()]
    bad = [f'weights/{n}' for n, p in trainer.model.named_parameters()
           if not torch.equal(p.detach(), init[n])]
    with recording_grad_reduce() as rec:
        got = one_step(trainer, tag, size)
    if float(got['loss']) != float(want['loss']):
        bad.append(f'loss {float(got["loss"])!r} vs {float(want["loss"])!r}')
    bad += [k for k in leaves(want, ('buffer/',))
            if not np.array_equal(got[k], want[k])]
    bad += [f'all-reduced grad/{n}' for n, a, b in zip(
        names, rec['before'], rec['after']) if not torch.equal(a, b)]
    replay = [torch.nn.Parameter(init[n].clone()) for n in names]
    for p, g in zip(replay, rec['after']):
        p.grad = g
    train.make_optimizer(replay, trainer.lr_schedule(0)).step()
    bad += [f'param/{n} after Adam' for n, p in zip(names, replay)
            if not np.array_equal(p.detach().cpu().numpy(),
                                  got[f'param/{n}'])]
    gaps = leaf_gaps(got, want, f64)
    limit = REPEAT_ERR[STEPS[tag][1]]
    if gaps['max_err'] > limit:
        bad.append(f'{gaps["worst_leaf"]}: {gaps["max_err"]:.2e} of its max '
                   f'from the step alone (<= {limit})')
    if gaps['degenerate_err'] > DEGENERATE_ERR:
        bad.append(f'degenerate leaves {gaps["degenerate_err"]:.2e} of the '
                   f'largest gradient from the step alone')
    if bad:
        raise AssertionError(f'{tag}: {bad}')
    return got, {k: v for k, v in gaps.items() if k not in ('cos', 'err')}


def _cos(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def scale_clouds(data: dict, factor: float = 1 + 1e-6) -> dict:
    """The same batch with its clouds scaled by ``factor`` (the bf16 gates'
    noise floor: one process's step on it)."""
    return dict(data, pc=(data['pc'] * factor).astype(data['pc'].dtype))


def batch_axis(kind: str) -> int:
    return 1 if kind == 'inv' else 0     # the 3DMatch legs' patches


def swap_halves(kind: str, data: dict) -> dict:
    """The same global batch with its halves in the other order: one
    process's step on it differs from its step on ``data`` by the order of
    its reductions alone."""
    axis = batch_axis(kind)

    def swap(v):
        h = v.shape[axis] // 2
        return np.concatenate([np.take(v, range(h, v.shape[axis]), axis),
                               np.take(v, range(h), axis)], axis)
    return {k: swap(v) for k, v in data.items()}


def halves(kind: str, data: dict):
    """The global batch's two halves, as two ranks would hold them."""
    axis = batch_axis(kind)

    def half(v, i):
        h = v.shape[axis] // 2
        return np.take(v, range(i * h, (i + 1) * h), axis)
    return tuple({k: half(v, i) for k, v in data.items()} for i in (0, 1))


def mean_of(results) -> dict:
    """The mean loss and gradients of steps run apart: two ranks'
    all-reduced step with every cross-sample quantity (norm statistics,
    mined negatives) taken over the rank's own half, the fault the
    collectives exist to prevent."""
    out = {'loss': np.float64(np.mean([float(r['loss']) for r in results]))}
    for k in leaves(results[0], ('grad/',)):
        out[k] = np.mean([r[k].astype(np.float64) for r in results], 0)
    return out


# The fp32 gates (lowest cosine, largest max error of the leaf's max abs)
# of a world's step against one process on the same global batch, per kind
# and per leaf with a real gradient, set between the card's readings of
# what the reduction order alone moves (one process again, on the batch
# with its halves swapped or rolled, two ranks) and of the fault of
# statistics and negatives taken over a rank's half (``dp_variants``; the
# readings are in PERF.md). inv and reg hold the order's own 1e-5 level.
# cls does not: block 0's skip BatchNorm normalizes a field constant over
# the batch, whose rounding (another in each order) 1 / sqrt(eps)
# amplifies, and the forward moves with it.
FP32_GATES = {'cls': (0.998, 0.4), 'inv': (0.99999, 1e-4),
              'reg': (0.99999, 1e-4)}
# one process's step run again, per real leaf, by dtype: the dTable's
# atomics move fp32's last bits; in bf16 such a bit can flip the rounding
# of the table's gradient to bf16 (2^-8 of an element)
REPEAT_ERR = {'fp32': 5e-5, 'bf16': 5e-2}
# a leaf whose float64 gradient is at most DEGENERATE_LEAF of the step's
# largest is mathematically ~0 (the BN-invariant biases, the branch behind
# block 0's skip BatchNorm, which normalizes a field constant over the
# batch): its fp32 gradient is rounding noise, amplified there by
# 1 / sqrt(eps), held in units of the step's largest gradient
DEGENERATE_LEAF = 1e-6
DEGENERATE_ERR = 1e-2


def leaf_gaps(got: dict, want: dict, f64: dict) -> dict:
    """How far ``got``'s gradients are from ``want``'s: the lowest cosine
    and the largest max error (of the leaf's max abs) over the leaves with
    a real gradient (per leaf in 'cos' and 'err'), the degenerate leaves'
    (``f64``: ``f64_grads``) largest difference in units of the step's
    largest gradient, and the loss's relative difference."""
    grads = leaves(want, ('grad/',))
    top = max(float(np.abs(v).max()) for v in grads.values())
    top64 = max(f64.values())
    gaps = {'min_cos': 1.0, 'max_err': 0.0, 'worst_leaf': None,
            'degenerate_err': 0.0, 'degenerate_leaves': 0,
            'loss_rel': abs(float(got['loss']) - float(want['loss']))
            / abs(float(want['loss'])), 'cos': {}, 'err': {}}
    for k, w in grads.items():
        g, w = got[k].astype(np.float64), w.astype(np.float64)
        if f64[k] <= DEGENERATE_LEAF * top64:
            gaps['degenerate_leaves'] += 1
            gaps['degenerate_err'] = max(gaps['degenerate_err'],
                                         float(np.abs(g - w).max()) / top)
            continue
        cos = _cos(g, w)
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                               1e-30)
        gaps['cos'][k], gaps['err'][k] = cos, err
        if err >= gaps['max_err']:
            gaps['max_err'], gaps['worst_leaf'] = err, k
        gaps['min_cos'] = min(gaps['min_cos'], cos)
    return gaps


def fp32_gates_hold(kind: str, gaps: dict) -> bool:
    cos_min, err_max = FP32_GATES[kind]
    return (gaps['loss_rel'] <= 1e-5 and gaps['min_cos'] >= cos_min
            and gaps['max_err'] <= err_max
            and gaps['degenerate_err'] <= DEGENERATE_ERR)


def compare(tag: str, got: dict, want: dict, f64: dict,
            noise=None) -> dict:
    """A world's step of ``tag`` (``got``, rank 0's results) against one
    process's on the same global batch (``want``); raises AssertionError
    naming every quantity off its gate, returns the readings.

    fp32: loss to rtol 1e-5, each leaf's gradient within the kind's
    ``FP32_GATES`` (cosine, max abs error of the leaf's max abs),
    a degenerate leaf (``leaf_gaps``; ``f64``: ``f64_grads``) within
    DEGENERATE_ERR of the step's largest gradient, running statistics to
    rtol 1e-4. bf16: the gates of
    [bf16-train] (loss to rtol 1e-3, per leaf cosine >= BF16_LEAF_COS, the
    median no lower than ``noise``'s, one process on the clouds
    x (1 + 1e-6), less 0.02, running statistics to 1e-3 of their
    magnitude; a degenerate leaf at most 4 times one process's plus
    1e-2)."""
    bf16 = tag.endswith('bf16')
    gaps = leaf_gaps(got, want, f64)
    lg, lw = float(got['loss']), float(want['loss'])
    bad = []
    if not (math.isfinite(lg) and gaps['loss_rel'] <= (1e-3 if bf16
                                                        else 1e-5)):
        bad.append(f'loss {lg:.7f} vs {lw:.7f}')
    floor = []
    if bf16:
        for k, cos in gaps['cos'].items():
            floor.append(_cos(noise[k], want[k]))
            if cos < BF16_LEAF_COS:
                bad.append(f'{k}: cosine {cos:.6f}')
        for k, w in leaves(want, ('grad/',)).items():
            if k not in gaps['cos'] and (float(np.abs(got[k]).max())
                                         > 4 * float(np.abs(w).max()) + 1e-2):
                bad.append(f'{k}: degenerate, max {np.abs(got[k]).max():.3e}')
        coss = list(gaps['cos'].values())
        if statistics.median(coss) < statistics.median(floor) - 0.02:
            bad.append(f'median cosine {statistics.median(coss):.5f} below '
                       f'the noise floor {statistics.median(floor):.5f} - '
                       f'0.02')
    else:
        cos_min, err_max = FP32_GATES[STEPS[tag][0]]
        bad += [f'{k}: cosine {c:.7f} (>= {cos_min})'
                for k, c in gaps['cos'].items() if c < cos_min]
        if gaps['max_err'] > err_max:
            bad.append(f'{gaps["worst_leaf"]}: max err {gaps["max_err"]:.2e} '
                       f'of the max (<= {err_max})')
        if gaps['degenerate_err'] > DEGENERATE_ERR:
            bad.append(f'degenerate leaves off by {gaps["degenerate_err"]:.2e}'
                       f' of the largest gradient (<= {DEGENERATE_ERR})')
    stat_err = 0.0
    for k, w in leaves(want, ('buffer/',)).items():
        if 'running' not in k:
            continue
        err, mag = float(np.abs(got[k] - w).max()), float(np.abs(w).max())
        lim = 1e-3 * mag + 1e-6 if bf16 else 1e-4 * max(mag, 1e-6)
        stat_err = max(stat_err, err / max(mag, 1e-30))
        if err > lim:
            bad.append(f'{k}: running statistic off by {err:.3e}')
    if bad:
        raise AssertionError(f'{tag}: {bad}')
    coss = list(gaps['cos'].values())
    return {'loss_world': lg, 'loss_one': lw, 'loss_rel': gaps['loss_rel'],
            'min_cos': gaps['min_cos'], 'max_err_of_leaf_max':
            gaps['max_err'], 'worst_leaf': gaps['worst_leaf'],
            'degenerate_leaves': gaps['degenerate_leaves'],
            'degenerate_err_of_top': gaps['degenerate_err'],
            'median_cos': statistics.median(coss) if bf16 else None,
            'noise_median_cos': statistics.median(floor) if floor else None,
            'max_stat_err_of_max': stat_err,
            'leaves': len(leaves(want, ('grad/',)))}


def check_routes(tag: str, ranks, want: dict) -> None:
    """Every kernel and every route the one-process step launched, launched
    on each rank too."""
    lw = json.loads(str(want['launches']))
    for r, res in enumerate(ranks):
        lr = json.loads(str(res['launches']))
        missing = [k for k, n in lw['counts'].items()
                   if n and not lr['counts'][k]]
        missing += [f'{conv}.{route}' for conv, rs in lw['routes'].items()
                    for route, n in rs.items()
                    if n and not lr['routes'][conv][route]]
        assert not missing, f'{tag} rank {r} launched none of {missing}'


def free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world: int, argv, timeout: float, log_dir: str,
           module: str = MODULE, env=None):
    """Start ``world`` ranks of ``python -m module argv`` with torchrun's
    rendezvous environment (127.0.0.1, a free port), each rank's output to
    ``log_dir``/rank<R>.log. Waits at most ``timeout`` seconds; a rank
    that exits non-zero, or the timeout, kills every rank and raises."""
    os.makedirs(log_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        e = dict(os.environ if env is None else env)
        # one host: the rendezvous, gloo and NCCL on the loopback
        e.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        e.setdefault('NCCL_SOCKET_IFNAME', 'lo')
        e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR='127.0.0.1',
                 MASTER_PORT=str(port),
                 PYTHONPATH=os.pathsep.join(
                     [root] + [p for p in [e.get('PYTHONPATH')] if p]))
        path = os.path.join(log_dir, f'rank{r}.log')
        logs.append(path)
        with open(path, 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, '-m', module] + list(argv), env=e,
                stdout=f, stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.time() > deadline:
                what = (f'rank {bad[0]} exited {codes[bad[0]]}' if bad else
                        f'timed out after {timeout:.0f} s')
                raise RuntimeError(f'{module} at world {world}: {what}\n'
                                   + _tails(logs))
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _tails(logs, n=4000):
    return '\n'.join(f'--- {p}\n{open(p).read()[-n:]}' for p in logs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', required=True)
    ap.add_argument('--steps', default=','.join(CARD_STEPS))
    ap.add_argument('--size', default='small', choices=tuple(SIZES))
    ap.add_argument('--device', default=None)
    ap.add_argument('--backend', default=None)
    ap.add_argument('--weights', action='append', default=[],
                    help='TAG=PATH: the state_dict step TAG loads (-r)')
    args = ap.parse_args(argv)
    from .distributed import (backend_for, device_for, init_distributed,
                              shutdown)
    device = device_for(args.device)
    init_distributed(backend=args.backend or backend_for(device))
    weights = dict(w.split('=', 1) for w in args.weights)
    rank = torch.distributed.get_rank()
    try:
        for tag in args.steps.split(','):
            res = run_step(tag, args.size, device, args.out,
                           weights.get(tag))
            np.savez(os.path.join(args.out, f'{tag}_rank{rank}.npz'), **res)
            print(f'[dryrun] rank {rank} {tag}: loss {float(res["loss"]):.7f}',
                  flush=True)
    finally:
        shutdown()


if __name__ == '__main__':
    main()
