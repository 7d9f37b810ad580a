"""Smoke run of the torch port (epn_pointcloud_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the four CUDA kernels from csrc/ (nvcc, sm_90a);
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
     by its expected count per batch.

Prints one line per comparison, a JSON line with per-kernel results, the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke_results.json and the nvcc/ptxas log to
chiprun_out/kernels_build.log.
"""

import json
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


def capture_calls(model, x):
    """Run one forward on the kernel path, recording each wrapper call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    calls = []
    saved = {}
    for mod in kernels.KERNELS:
        fn_name = mod.NAME
        orig = getattr(mod, fn_name)
        saved[mod] = orig

        def rec(*args, _orig=orig, _name=fn_name, **kw):
            calls.append((_name, args, kw))
            return _orig(*args, **kw)
        setattr(mod, fn_name, rec)
    try:
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()
    finally:
        for mod, orig in saved.items():
            setattr(mod, mod.NAME, orig)
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


def phase_kernels(model, device):
    """Each kernel vs its plain version at every flagship layer shape."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    calls = capture_calls(model, x)
    plain = {'fps': kernels.fps.fps_plain,
             'ball_query': kernels.ball_query.ball_query_plain,
             'inter_conv': kernels.inter_conv.inter_conv_plain,
             'intra_conv': kernels.intra_conv.intra_conv_plain}
    mods = {m.NAME: m for m in kernels.KERNELS}
    results = {m.NAME: [] for m in kernels.KERNELS}
    layer_of = {m.NAME: 0 for m in kernels.KERNELS}
    failures = []
    for name, args, kw in calls:
        # model layer: the inter conv kernel starts at layer 1 (layer 0's
        # occupancy-ones input runs in plain torch)
        layer = layer_of[name] + (1 if name == 'inter_conv' else 0)
        layer_of[name] += 1
        kern_fn = getattr(mods[name], name)
        got = kern_fn(*args, **kw)
        want = plain[name](*args, **kw)
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
        p_ms = time_ms(lambda: plain[name](*args, **kw),
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
    expect = {'fps': 1, 'ball_query': 7, 'inter_conv': 6, 'intra_conv': 7}
    for name, per_batch in expect.items():
        assert counts[name] == per_batch * n_batches, (name, counts)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, n_batches


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
        counts, n_batches = phase_eval()
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
    for mod in kernels.KERNELS:
        rows = results[mod.NAME]
        summary.append({
            'name': mod.NAME, 'route': 'cuda', 'source': mod.SOURCE,
            'replaces': mod.REPLACES, 'launches': counts[mod.NAME],
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': sum(r['ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows)})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_results.json'), 'w') as f:
        json.dump({'card': card, 'device': torch.cuda.get_device_name(0),
                   'torch': torch.__version__, 'cuda': torch.version.cuda,
                   'batch': BATCH, 'per_layer': results,
                   'model_b8_max_abs_err': model_err,
                   'forward_b32': forward,
                   'eval_batches': n_batches, 'eval_launches': counts,
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
