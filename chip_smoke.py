"""Smoke run of the torch port (epn_pointcloud_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the CUDA kernels from csrc/ (one nvcc a source, in parallel,
     sm_90a);
  2. at every flagship layer shape of cls_so3net_pn (b=32, 1024 points, 60
     anchors), compare each kernel with its plain PyTorch version on the
     card, on the inputs the model itself gives it (captured from a b=32
     forward of a seeded full-width model on a synthetic cloud batch), and
     time both (median of CUDA-event timings after warmup);
  3. run the full forward at b=8 on the kernel path and on the plain path;
     the logits must agree to rtol=1e-3, atol=2e-3; then time the whole
     b=32 forward on both paths, in turns;
  4. write a synthetic ModelNet40 test tree (1024-point clouds, 2 batches of
     32) and run the eval entry point (run_modelnet --run-mode eval -b 32) on
     it; the logits must be finite and every kernel's launch count must rise
     by its expected count per batch;
  5. capture each backward kernel call of one train-mode step of the seeded
     full-width model on a synthetic b=12 batch (inter dTable and dW at 6
     layers, intra df and dW at 7) and compare each with its plain version
     on the same inputs (normwise relative error <= 1e-5 for dTable and df,
     <= 1e-4 for the dW reductions), timing both;
  6. one train step (b=12) on the kernel path and on the plain path
     (``kernels.plain()``: plain forward, torch autograd) from the same
     weights: loss to rtol 1e-5, per-leaf gradients by the rule of
     tests/test_reference_train_parity.py, BatchNorm running statistics to
     rtol 1e-4; then the whole step (forward, backward, Adam) timed on both
     paths in turns, and 10 Adam steps on one batch must lower the loss;
  7. write a synthetic tree with train and testR splits and run the train
     entry point (run_modelnet --run-mode train -i 4 --save-freq 4): finite
     logged losses, each kernel's launch count risen by its per-step count
     (plus the eval at iteration 4), and the saved checkpoint evaluated
     through --run-mode eval -r.

Prints one line per comparison, a JSON line with per-kernel results, the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke_results.json and the nvcc/ptxas log to
chiprun_out/kernels_build.log.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
WORK_DIR = os.path.join(ROOT, 'build', 'chip_smoke')
BATCH = 32
TRAIN_BATCH = 12
N_POINTS = 1024
SEED = 2913


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=10, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def synthetic_batch(b, n, seed):
    """b normalized synthetic clouds of n points (the test-split shapes)."""
    import numpy as np
    from epn_pointcloud_tpu_torch.data import pc as pctk
    from epn_pointcloud_tpu_torch.data import synthetic
    rng = np.random.RandomState(seed)
    clouds = [pctk.normalize_np(synthetic.make_shape(rng, n, i % 8).T).T
              for i in range(b)]
    return np.stack(clouds).astype(np.float32)


def full_opt(dataset_path='unused'):
    from epn_pointcloud_tpu_torch.app import config
    opt = config.parse_args(['experiment', '-d', dataset_path])
    opt.model.model = 'cls_so3net_pn'
    opt.model.flag = 'attention'
    return opt


def phase_build():
    from epn_pointcloud_tpu_torch.ops.kernels import build
    t0 = time.time()
    build.library()
    dt = time.time() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'kernels_build.log'), 'w') as f:
        f.write(build.build_log)
    for line in build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'[build] {line.strip()}')
    log(f'[build] kernels built and loaded in {dt:.1f} s')


def capture_calls(names, run):
    """Run ``run()``, recording each call of the named kernel wrappers
    (module function names in ops/kernels) as (name, args)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    mods = {n: m for m in (kernels.fps, kernels.ball_query,
                           kernels.inter_conv, kernels.intra_conv)
            for n in names if hasattr(m, n)}
    calls = []
    saved = {n: getattr(m, n) for n, m in mods.items()}

    def recorder(name, orig):
        def rec(*args):
            calls.append((name, args))
            return orig(*args)
        return rec
    for n, m in mods.items():
        setattr(m, n, recorder(n, saved[n]))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, m in mods.items():
            setattr(m, n, saved[n])
    return calls


def _shape_desc(name, args):
    if name == 'fps':
        return f'xyz {tuple(args[0].shape)} -> {args[1]}'
    if name == 'ball_query':
        return (f'query {tuple(args[0].shape)} support {tuple(args[1].shape)}'
                f' ns={args[3]} r={args[2]:.4f}')
    if name == 'inter_conv':
        gx, idx, tab, W = args[0], args[1], args[2], args[5]
        return (f'b={tab.shape[0]} p1={tab.shape[1]} p2={idx.shape[1]} '
                f'nn={idx.shape[2]} c={tab.shape[3]} d={W.shape[2]} '
                f'sigma={args[6]:.4f}')
    f, W = args[0], args[2]
    return f'b={f.shape[0]} p={f.shape[1]} c={f.shape[3]} d={W.shape[2]}'


FWD = ('fps', 'ball_query', 'inter_conv', 'intra_conv')


def phase_kernels(model, device):
    """Each kernel vs its plain version at every flagship layer shape."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)

    def run():
        with torch.no_grad():
            model(x)
    calls = capture_calls(FWD, run)
    entries = {k.name: k for k in kernels.KERNELS}
    results = {n: [] for n in FWD}
    layer_of = dict.fromkeys(FWD, 0)
    failures = []
    for name, args in calls:
        kw = {}
        # model layer: the inter conv kernel starts at layer 1 (layer 0's
        # occupancy-ones input runs in plain torch)
        layer = layer_of[name] + (1 if name == 'inter_conv' else 0)
        layer_of[name] += 1
        kern_fn = getattr(entries[name].module, name)
        plain_fn = getattr(entries[name].module, entries[name].plain)
        got = kern_fn(*args, **kw)
        want = plain_fn(*args, **kw)
        torch.cuda.synchronize()
        if name in ('fps', 'ball_query'):
            ok = torch.equal(got, want)
            max_err = float((got.long() - want.long()).abs().max())
            rel = max_err
            tol = 'exact'
        else:
            depth = 24 * args[2].shape[-1] if name == 'inter_conv' else \
                24 * args[0].shape[-1]
            diff = (got - want).abs()
            max_err = float(diff.max())
            rel = float((got - want).norm() / want.norm())
            rtol = max(1e-5, depth * 1.3e-7)
            within = bool((diff <= 1e-4 + rtol * want.abs()).all())
            ok = rel <= 1e-5 and within and bool(torch.isfinite(got).all())
            tol = f'rel_norm<=1e-5, rtol={rtol:.2e}, atol=1e-4'
        k_ms = time_ms(lambda: kern_fn(*args, **kw),
                       reps=5 if name == 'fps' else 10)
        p_ms = time_ms(lambda: plain_fn(*args, **kw),
                       reps=5 if name == 'fps' else 10)
        desc = _shape_desc(name, args)
        log(f'[compare] {name} L{layer} ({desc}): max_abs_err={max_err:.3e} '
            f'rel_norm_err={rel:.3e} [{tol}] kernel_ms={k_ms:.4f} '
            f'plain_ms={p_ms:.4f} {"OK" if ok else "FAIL"}')
        results[name].append({'layer': layer, 'shape': desc,
                              'max_abs_err': max_err, 'rel_norm_err': rel,
                              'ms': k_ms, 'plain_ms': p_ms, 'ok': ok})
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    expect = {'fps': 1, 'ball_query': 7, 'inter_conv': 6, 'intra_conv': 7}
    for name, n in expect.items():
        if len(results[name]) != n:
            failures.append(f'{name}: {len(results[name])} calls in one '
                            f'forward, expected {n}')
    if failures:
        raise AssertionError(f'kernel comparisons failed: {failures}')
    return results


def phase_model(model, device):
    """Full forward at b=8: kernel path vs plain path on the card."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(8, N_POINTS, SEED + 1)).to(device)
    with torch.no_grad():
        k_logits, k_att = model(x)
        with kernels.plain():
            p_logits, p_att = model(x)
    torch.cuda.synchronize()
    err = float((k_logits - p_logits).abs().max())
    log(f'[model] b=8 logits {tuple(k_logits.shape)} kernel vs plain '
        f'max_abs_err={err:.3e} (rtol=1e-3, atol=2e-3); attention logits '
        f'max_abs_err={float((k_att - p_att).abs().max()):.3e}')
    assert k_logits.shape == (8, 40) and torch.isfinite(k_logits).all()
    torch.testing.assert_close(k_logits, p_logits, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(k_att, p_att, rtol=1e-3, atol=2e-3)
    return err


def phase_forward_time(model, device, reps=5):
    """Whole b=32 forward on the card, kernel path and plain path in turns
    (CUDA events; the median of each)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 2)).to(device)

    def plain_fwd():
        with kernels.plain():
            model(x)
    k_ts, p_ts = [], []
    with torch.no_grad():
        model(x)
        plain_fwd()
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    log(f'[forward] b={BATCH} whole forward: kernel path {k_ms:.2f} ms '
        f'({1e3 * BATCH / k_ms:.1f} clouds/s), plain path {p_ms:.2f} ms '
        f'({1e3 * BATCH / p_ms:.1f} clouds/s); median of {reps} turns')
    return {'kernel_ms': k_ms, 'plain_ms': p_ms, 'kernel_runs_ms': k_ts,
            'plain_runs_ms': p_ts}


def phase_eval():
    """The main path: run_modelnet eval on a synthetic test tree."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels
    tree = os.path.join(WORK_DIR, 'modelnet')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=0, n_test=16,
                                 n_points=N_POINTS, seed=0, splits=('testR',))
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', str(BATCH),
            '--model-dir', os.path.join(WORK_DIR, 'runs')]
    kernels.reset_counts()
    t0 = time.time()
    trainer = run_modelnet.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.counts()
    trainer.logger.close()
    n_batches = len(trainer.eval_logits)
    logits = torch.cat(trainer.eval_logits)
    log(f'[eval] run_modelnet eval: {n_batches} batches of {BATCH}, logits '
        f'{tuple(logits.shape)}, accuracy {trainer.test_accs[-1]:.2f}%, '
        f'wall {wall:.2f} s (build, data and setup included); kernel '
        f'launches {counts}')
    assert n_batches >= 2 and logits.shape == (n_batches * BATCH, 40)
    assert torch.isfinite(logits).all(), 'non-finite eval logits'
    expect = {n: per * n_batches for n, per in EVAL_PER_BATCH.items()}
    assert counts == expect, (counts, expect)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, n_batches


# kernel launches of one eval batch, and of one train step: the forward's,
# plus the backward's: intra df runs the forward intra kernel on the inverse
# adjacency (7 more), dTable and dW at the 6 kernel inter layers (layer 0's
# ones input is plain torch), intra dW at all 7
EVAL_PER_BATCH = {'fps': 1, 'ball_query': 7, 'inter_conv': 6,
                  'inter_conv_dtable': 0, 'inter_conv_dw': 0,
                  'intra_conv': 7, 'intra_conv_dw': 0}
TRAIN_PER_STEP = {'fps': 1, 'ball_query': 7, 'inter_conv': 6,
                  'inter_conv_dtable': 6, 'inter_conv_dw': 6,
                  'intra_conv': 14, 'intra_conv_dw': 7}
BWD = ('inter_conv_dtable', 'inter_conv_dw', 'intra_conv_df', 'intra_conv_dw')


def train_batch(device, seed):
    """(clouds [12, 1024, 3], class labels, anchor labels) on the card."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x = synthetic_batch(TRAIN_BATCH, N_POINTS, seed)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(rng.randint(0, 40, TRAIN_BATCH)).to(device),
            torch.from_numpy(rng.randint(0, 60, TRAIN_BATCH)).to(device))


def step_loss(model, batch):
    """Forward and the training loss (attention CE, 'default', margin 1)."""
    from epn_pointcloud_tpu_torch import losses
    pred, feat = model(batch[0])
    return losses.attention_cross_entropy(pred, batch[1], feat, batch[2],
                                          'default', 1.0)[0]


def phase_backward_kernels(device):
    """Each backward kernel vs its plain version at every flagship layer, on
    the inputs one b=12 train step gives it."""
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    model = models.build_model_from(full_opt(), seed=SEED).to(device).train()
    batch = train_batch(device, SEED + 3)
    calls = capture_calls(BWD, lambda: step_loss(model, batch).backward())
    del model
    ic, ik = kernels.inter_conv, kernels.intra_conv
    # name -> (kernel wrapper, plain version, plain's arguments, tolerance on
    # the normwise relative error); dW sums up to b*p*60 = 368,640 rows
    spec = {'inter_conv_dtable': (ic.inter_conv_dtable,
                                  ic.inter_conv_dtable_plain, None, 1e-5),
            'inter_conv_dw': (ic.inter_conv_dw, ic.inter_conv_dw_plain, None,
                              1e-4),
            'intra_conv_df': (ik.intra_conv_df, ik.intra_conv_df_plain,
                              (0, 1, 3), 1e-5),
            'intra_conv_dw': (ik.intra_conv_dw, ik.intra_conv_dw_plain, None,
                              1e-4)}
    n_calls = {n: sum(1 for c in calls if c[0] == n) for n in BWD}
    seen = dict.fromkeys(BWD, 0)
    results = {n: [] for n in BWD}
    failures = []
    torch.set_grad_enabled(False)
    for name, args in calls:
        kern_fn, plain_fn, pick, tol = spec[name]
        pargs = args if pick is None else tuple(args[i] for i in pick)
        # the backward runs from the last layer down
        layer = n_calls[name] - seen[name] - (0 if name.startswith('inter')
                                              else 1)
        seen[name] += 1
        got = kern_fn(*args)
        want = plain_fn(*pargs)
        torch.cuda.synchronize()
        max_err = float((got - want).abs().max())
        rel = float((got - want).norm() / want.norm())
        ok = rel <= tol and bool(torch.isfinite(got).all())
        k_ms = time_ms(lambda: kern_fn(*args), reps=5, warmup=2)
        p_ms = time_ms(lambda: plain_fn(*pargs), reps=5, warmup=2)
        shape = tuple(want.shape)
        log(f'[backward] {name} L{layer} (out {shape}): max_abs_err='
            f'{max_err:.3e} rel_norm_err={rel:.3e} [rel_norm<={tol:.0e}] '
            f'kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} '
            f'{"OK" if ok else "FAIL"}')
        results[name].append({'layer': layer, 'shape': str(shape),
                              'max_abs_err': max_err, 'rel_norm_err': rel,
                              'ms': k_ms, 'plain_ms': p_ms, 'ok': ok})
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    torch.set_grad_enabled(True)
    expect = {'inter_conv_dtable': 6, 'inter_conv_dw': 6, 'intra_conv_df': 7,
              'intra_conv_dw': 7}
    if n_calls != expect:
        failures.append(f'backward calls {n_calls}, expected {expect}')
    if failures:
        raise AssertionError(f'backward kernel comparisons failed: {failures}')
    return results


def _grads_close(name, g, w, f64_max):
    """The per-leaf rule of tests/test_reference_train_parity.py: relative
    L2 <= 1e-2 and max error <= 5e-2 * max|g|. A leaf whose float64
    gradient is ~0 (<= 1e-5: BN-invariant biases, the block-0
    constant-field branch) has no fp32 value to compare relatively, only
    rounding noise from a plain-torch branch both paths share: the two must
    agree within 2e-3 absolute. So must leaves where both are <= 1e-3, and
    then the float64 gradient must be <= 1e-3 too (no real gradient
    masked)."""
    err = float((g - w).abs().max())
    tiny = max(float(g.abs().max()), float(w.abs().max())) <= 1e-3
    if f64_max <= 1e-5 or tiny:
        return (err <= 2e-3 and f64_max <= 1e-3,
                f'{name}: degenerate (fp64 max {f64_max:.1e}), '
                f'max|diff|={err:.3e}')
    scale = float(w.abs().max())
    l2 = float((g - w).norm() / w.norm())
    return (err <= 5e-2 * scale and l2 <= 1e-2,
            f'{name}: max|diff|={err:.3e} (scale {scale:.3e}) relL2={l2:.3e}')


def f64_grad_max(model, batch):
    """Per-leaf max |gradient| of a float64 copy of ``model`` on the plain
    path (the exact-arithmetic stand-in that marks degenerate leaves)."""
    import copy
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    m64 = copy.deepcopy(model).double()
    with kernels.plain():
        step_loss(m64, (batch[0].double(),) + batch[1:]).backward()
    out = {n: float(p.grad.abs().max()) if p.grad is not None else 0.0
           for n, p in m64.named_parameters()}
    del m64
    torch.cuda.empty_cache()
    return out


def perturb_norm_biases(model, seed=5):
    """Shift every norm bias off zero, as tests/test_reference_train_parity.py
    does: at init the block-0 skip branch is a BatchNorm over a constant
    field, whose output is 0 up to rounding, so its leaky-ReLU mask and the
    gradients behind it are rounding noise (~1e-2 here), not a quantity two
    paths can agree on. Off zero, the mask is fixed and those gradients are
    the exact zeros they are meant to be, up to noise <= 1e-3."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if '.norm.' in name and name.endswith('.bias'):
                p += torch.from_numpy(
                    0.3 * rng.randn(*p.shape).astype(np.float32)).to(p.device)
    return model


def phase_train_step(device, reps=5):
    """One b=12 train step on the kernel path and on the plain path from the
    same weights (seeded, norm biases perturbed); then the whole step timed
    on both, and 10 Adam steps."""
    import torch
    from epn_pointcloud_tpu_torch import models, train
    from epn_pointcloud_tpu_torch.ops import kernels
    mk, mp = (perturb_norm_biases(models.build_model_from(
        full_opt(), seed=SEED)).to(device).train() for _ in range(2))
    batch = train_batch(device, SEED + 4)
    f64 = f64_grad_max(mp, batch)
    kernels.reset_counts()
    loss_k = step_loss(mk, batch)
    loss_k.backward()
    counts_k = kernels.counts()
    with kernels.plain():
        loss_p = step_loss(mp, batch)
        loss_p.backward()
    torch.cuda.synchronize()
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == TRAIN_PER_STEP, (counts_k, TRAIN_PER_STEP)
    lk, lp = loss_k.item(), loss_p.item()
    log(f'[train] b={TRAIN_BATCH} loss kernel path {lk:.7f}, plain path '
        f'{lp:.7f} (rtol 1e-5)')
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    bad, degen, worst = [], [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        g = pk[name].grad
        ok, msg = _grads_close(name, g if g is not None else
                               torch.zeros_like(p), p.grad if p.grad is not
                               None else torch.zeros_like(p), f64[name])
        if not ok:
            bad.append(msg)
        elif 'degenerate' in msg:
            degen.append(msg)
        if f64[name] > 1e-5:
            l2 = float((pk[name].grad - p.grad).norm()
                       / p.grad.norm().clamp(min=1e-30))
            worst = max(worst, (l2, name))
    log(f'[train] gradients: {len(pk)} leaves, worst relative L2 '
        f'{worst[0]:.3e} at {worst[1]}; {len(degen)} degenerate leaves '
        f'(fp64 gradient <= 1e-5 or both <= 1e-3): {"; ".join(degen)}')
    assert not bad, bad
    bk = dict(mk.named_buffers())
    n_stats, stat_err = 0, 0.0
    for name, buf in mp.named_buffers():
        if 'running' in name:
            torch.testing.assert_close(bk[name], buf, rtol=1e-4, atol=1e-6)
            stat_err = max(stat_err, float((bk[name] - buf).abs().max()))
            n_stats += 1
    log(f'[train] BatchNorm running stats: {n_stats} buffers, max '
        f'abs diff {stat_err:.3e} (rtol 1e-4)')

    opt_k = train.make_optimizer(mk.parameters(), 1e-3)
    opt_p = train.make_optimizer(mp.parameters(), 1e-3)

    def step_k():
        opt_k.zero_grad(set_to_none=True)
        step_loss(mk, batch).backward()
        opt_k.step()

    def step_p():
        with kernels.plain():
            opt_p.zero_grad(set_to_none=True)
            step_loss(mp, batch).backward()
            opt_p.step()
    step_k()
    step_p()
    k_ts, p_ts = [], []
    for _ in range(reps):
        k_ts.append(time_ms(step_k, reps=1, warmup=0))
        p_ts.append(time_ms(step_p, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    log(f'[train] b={TRAIN_BATCH} whole train step (forward, backward, '
        f'Adam): kernel path {k_ms:.2f} ms ({1e3 * TRAIN_BATCH / k_ms:.1f} '
        f'clouds/s), plain path {p_ms:.2f} ms ({1e3 * TRAIN_BATCH / p_ms:.1f}'
        f' clouds/s); median of {reps} turns')
    del mp, opt_p
    torch.cuda.empty_cache()
    trace = []
    for i in range(11):
        loss = step_loss(mk, batch)
        trace.append(loss.item())
        if i < 10:
            opt_k.zero_grad(set_to_none=True)
            loss.backward()
            opt_k.step()
    log(f'[train] 10 Adam steps on one batch, kernel path: loss '
        f'{trace[0]:.4f} -> {trace[-1]:.4f}')
    assert all(map(math.isfinite, trace)) and trace[-1] < trace[0], trace
    return {'loss_kernel': lk, 'loss_plain': lp, 'kernel_ms': k_ms,
            'plain_ms': p_ms, 'kernel_runs_ms': k_ts, 'plain_runs_ms': p_ts,
            'worst_grad_rel_l2': worst[0], 'adam_trace': trace}


def phase_train_entry():
    """The main path of this slice: run_modelnet train on a synthetic tree,
    then the saved checkpoint through run_modelnet eval -r."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels
    tree = os.path.join(WORK_DIR, 'modelnet')
    runs = os.path.join(WORK_DIR, 'runs')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=9, n_test=3,
                                 n_points=N_POINTS, seed=0,
                                 splits=('train', 'testR'))
    steps = 4
    argv = ['experiment', '-d', tree, '--run-mode', 'train', '-i', str(steps),
            '--save-freq', str(steps), '-lf', '1', '--model-dir', runs]
    kernels.reset_counts()
    t0 = time.time()
    trainer = run_modelnet.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.counts()
    trainer.logger.close()
    n_eval = len(trainer.eval_logits)
    stats = dict(trainer.summary.running_stats)
    log(f'[train-entry] run_modelnet train: {steps} steps of '
        f'{TRAIN_BATCH} over {len(trainer.dataset)} batches an epoch, eval '
        f'of {n_eval} batch(es) at step {steps}; running stats {stats}; wall '
        f'{wall:.2f} s (data and setup included); kernel launches {counts}')
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'R_Loss'))
    assert math.isfinite(float(trainer.last_loss))
    expect = {n: steps * TRAIN_PER_STEP[n] + n_eval * EVAL_PER_BATCH[n]
              for n in TRAIN_PER_STEP}
    assert n_eval >= 1 and counts == expect, (counts, expect)
    ckpt = trainer.last_ckpt
    assert os.path.exists(ckpt), ckpt
    other = run_modelnet.main(['experiment', '-d', tree, '--run-mode', 'eval',
                               '-b', str(TRAIN_BATCH), '-r', ckpt,
                               '--model-dir', runs])
    other.logger.close()
    got, want = torch.cat(other.eval_logits), torch.cat(trainer.eval_logits)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    log(f'[train-entry] checkpoint {os.path.basename(ckpt)} reloaded through '
        f'--run-mode eval -r: logits {tuple(got.shape)} equal the trained '
        f'model\'s (max abs diff {float((got - want).abs().max()):.3e})')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, wall


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port smoke run needs one',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import epn_pointcloud_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: cannot import the port: {e}', file=sys.stderr)
        return 1
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.app.trainer import set_fp32_parity
    from epn_pointcloud_tpu_torch.ops import kernels

    set_fp32_parity()
    device = torch.device('cuda')
    t_start = time.time()
    try:
        phase_build()
        model = models.build_model_from(full_opt(), seed=SEED).to(device).eval()
        results = phase_kernels(model, device)
        model_err = phase_model(model, device)
        forward = phase_forward_time(model, device)
        del model
        torch.cuda.empty_cache()
        eval_counts, n_batches = phase_eval()
        results.update(phase_backward_kernels(device))
        torch.cuda.empty_cache()
        train_step = phase_train_step(device)
        torch.cuda.empty_cache()
        counts, train_wall = phase_train_entry()
    except Exception:
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        'nvidia-smi unavailable'
    summary = []
    for k in kernels.KERNELS:
        rows = results[k.name]
        rec = {'name': k.name, 'route': 'cuda', 'source': k.source,
               'replaces': k.replaces, 'launches': counts[k.name],
               'max_abs_err': max(r['max_abs_err'] for r in rows),
               'ms': sum(r['ms'] for r in rows),
               'plain_ms': sum(r['plain_ms'] for r in rows)}
        if k.name == 'intra_conv':
            # df runs this kernel (b=12 train step); ms above: b=32 forward
            df = results['intra_conv_df']
            rec['max_abs_err'] = max([rec['max_abs_err']]
                                     + [r['max_abs_err'] for r in df])
            rec['df_ms'] = sum(r['ms'] for r in df)
            rec['df_plain_ms'] = sum(r['plain_ms'] for r in df)
        rec['eval_launches'] = eval_counts[k.name]
        summary.append(rec)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_results.json'), 'w') as f:
        json.dump({'card': card, 'device': torch.cuda.get_device_name(0),
                   'torch': torch.__version__, 'cuda': torch.version.cuda,
                   'batch': BATCH, 'train_batch': TRAIN_BATCH,
                   'per_layer': results, 'model_b8_max_abs_err': model_err,
                   'forward_b32': forward, 'train_step_b12': train_step,
                   'eval_batches': n_batches, 'eval_launches': eval_counts,
                   'train_launches': counts, 'train_entry_wall_s': train_wall,
                   'seconds': time.time() - t_start}, f, indent=1)
    log(f'[done] {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': summary}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
