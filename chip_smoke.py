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
  4. the bf16 production mode (--compute-dtype bf16) of the same model:
     each kernel call of a b=32 bf16 forward (ones conv, bf16 inter conv,
     prenorm intra conv, moments, fused tail, grouped conv) against its
     plain version on the same inputs (normwise <= 4e-3 for bf16 outputs,
     <= 1e-5 for the moments' fp32 sums), timed, with torch.addmm beside
     the grouped conv; the b=8 bf16 logits on the kernel and plain paths to
     a per-sample cosine >= 0.9999, the b=32 bf16 and fp32 kernel paths to
     a minimum cosine >= 0.999, and the whole b=32 bf16 forward timed on
     both paths, in turns;
  5. write a synthetic ModelNet40 test tree (1024-point clouds, 2 batches of
     32) and run the eval entry point (run_modelnet --run-mode eval -b 32) on
     it, in fp32 and then with --compute-dtype bf16 (this slice's main
     path); the logits must be finite and every kernel's launch count must
     rise by its expected count per batch;
  6. capture each backward kernel call of one train-mode step of the seeded
     full-width model on a synthetic b=12 batch (inter dTable and dW at 6
     layers, intra df and dW at 7) and compare each with its plain version
     on the same inputs (normwise relative error <= 1e-5 for dTable and df,
     <= 1e-4 for the dW reductions), timing both;
  7. one train step (b=12) on the kernel path and on the plain path
     (``kernels.plain()``: plain forward, torch autograd) from the same
     weights: loss to rtol 1e-5, per-leaf gradients by the rule of
     tests/test_reference_train_parity.py, BatchNorm running statistics to
     rtol 1e-4; then the whole step (forward, backward, Adam) timed on both
     paths in turns, and 10 Adam steps on one batch must lower the loss;
  8. write a synthetic tree with train and testR splits and run the train
     entry point (run_modelnet --run-mode train -i 4 --save-freq 4): finite
     logged losses, each kernel's launch count risen by its per-step count
     (plus the eval at iteration 4), and the saved checkpoint evaluated
     through --run-mode eval -r.

Prints one line per comparison, a JSON line with per-kernel results (each
with its bound: the larger of its bytes over 3.35 TB/s and its operations
over the peak for their type, 67 TFLOP/s fp32 or 989 TFLOP/s bf16, from the
shapes of the calls timed), the card's name and power limit, and as its
last line
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
# the H100 SXM's published peaks (NVIDIA data sheet, dense): fp32 on the
# CUDA cores, bf16 on the tensor cores, and device memory
PEAK_FP32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def _nbytes(ts):
    import torch
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(name, args, out):
    """(bytes, fp32 operations, bf16 operations) one call of kernel ``name``
    needs at these shapes: each input read once and each output written
    once; the algorithm's operations, the products of a bf16 kernel counted
    as bf16 tensor-core work and everything else as fp32."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    nb = _nbytes(list(args) + list(outs))
    f32 = mm = 0
    bf16 = False
    if name == 'fps':
        b, n, _ = args[0].shape
        f32 = 10 * b * args[1] * n           # a distance, min and argmax a point
    elif name == 'ball_query':
        q, sup = args[0], args[1]
        f32 = 9 * q.shape[0] * q.shape[1] * sup.shape[1]
    elif name == 'ones_conv':
        b, p2, nn, _ = args[0].shape
        na, K = args[1].shape[:2]
        f32 = 10 * b * p2 * nn * na * K     # a weight and its sum
    elif name.startswith('inter_conv'):
        gx, idx, rk = args[0], args[1], args[3]
        b, p2, nn = idx.shape
        na, K = rk.shape[:2]
        if name == 'inter_conv':
            c, d, bf16 = (args[2].shape[3], args[5].shape[2],
                          args[2].dtype == torch.bfloat16)
        elif name == 'inter_conv_dtable':
            c, d = args[5].shape[1], args[5].shape[2]
        else:
            c, d = args[2].shape[3], args[5].shape[-1]
        M = b * p2 * na
        f32 = 9 * M * nn * K                 # anchor weights
        mm = 2 * M * nn * K * c + 2 * M * K * c * d
    elif name.startswith('intra_conv'):
        f = args[0]
        b, p, na, c = f.shape
        W = {'intra_conv': 2, 'intra_conv_df': 3,
             'intra_conv_prenorm': 3}.get(name)
        if W is None:                        # dW: [K, c, d] from f and dout
            K, d = args[1].shape[1], args[2].shape[3]
        else:
            K, c, d = args[W].shape
        bf16 = f.dtype == torch.bfloat16
        mm = 2 * b * p * na * K * c * d
        if name == 'intra_conv_prenorm':
            f32 = 3 * f.numel()              # the fold and activation
    elif name == 'moments':
        f32 = 3 * args[0].numel()
    elif name.startswith('grouped_conv'):
        x, W = args[0], args[1]
        M = x.numel() // W.shape[0]
        bf16 = x.dtype == torch.bfloat16
        mm = 2 * M * W.shape[0] * W.shape[1]
        f32 = (8 if name == 'grouped_conv_tail' else 1) * M * W.shape[1]
    else:
        raise KeyError(name)
    return nb, (f32 + (0 if bf16 else mm)), (mm if bf16 else 0)


def bound_ms(name, args, out):
    """(bytes ms, operations ms) of the least time the card could take for
    one call: bytes over the memory rate, operations over their peak."""
    nb, f32, b16 = work(name, args, out)
    return 1e3 * nb / HBM_BYTES_S, 1e3 * max(f32 / PEAK_FP32,
                                             b16 / PEAK_BF16)


def rel_err(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


class compute_dtype:
    """The port's compute dtype inside the block, fp32 after it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from epn_pointcloud_tpu_torch.ops import so3conv
        so3conv.set_compute_dtype(self.name)

    def __exit__(self, *exc):
        from epn_pointcloud_tpu_torch.ops import so3conv
        so3conv.set_compute_dtype('fp32')


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
    mods = {n: m for m in kernels.MODULES for n in names if hasattr(m, n)}
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
    if name == 'ones_conv':
        return (f'gx {tuple(args[0].shape)} -> F {args[4]} '
                f'sigma={args[3]:.4f}')
    if name == 'moments':
        return f'x {tuple(args[0].shape)} {args[0].dtype}'
    if name.startswith('grouped_conv'):
        x, W = args[0], args[1]
        return (f'b={x.shape[0]} p={x.shape[1]} c={W.shape[0]} '
                f'd={W.shape[1]} {x.dtype}')
    f, W = args[0], args[3 if name == 'intra_conv_prenorm' else 2]
    return (f'b={f.shape[0]} p={f.shape[1]} c={f.shape[3]} d={W.shape[2]} '
            f'{f.dtype}')


def _aggregate(rows):
    """Sums of a kernel's per-call rows: its time, plain time, bound and
    library time over the layers of one forward or step."""
    bytes_ms = sum(r['bytes_ms'] for r in rows)
    ops_ms = sum(r['ops_ms'] for r in rows)
    lib = [r.get('library_ms') for r in rows]
    return {'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': sum(r['ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows),
            'bound_ms': sum(max(r['bytes_ms'], r['ops_ms']) for r in rows),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'library_ms': None if None in lib else sum(lib), 'calls': len(rows)}


FWD = ('fps', 'ball_query', 'ones_conv', 'inter_conv', 'intra_conv')


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
        # occupancy-ones input runs the ones conv)
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
        b_ms, o_ms = bound_ms(name, args, got)
        desc = _shape_desc(name, args)
        log(f'[compare] {name} L{layer} ({desc}): max_abs_err={max_err:.3e} '
            f'rel_norm_err={rel:.3e} [{tol}] kernel_ms={k_ms:.4f} '
            f'plain_ms={p_ms:.4f} bound_ms={max(b_ms, o_ms):.4f} '
            f'{"OK" if ok else "FAIL"}')
        results[name].append({'layer': layer, 'shape': desc,
                              'max_abs_err': max_err, 'rel_norm_err': rel,
                              'ms': k_ms, 'plain_ms': p_ms, 'bytes_ms': b_ms,
                              'ops_ms': o_ms, 'ok': ok})
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    expect = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
              'intra_conv': 7}
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


def phase_forward_time(model, device, reps=5, dtype='fp32'):
    """Whole b=32 forward on the card, kernel path and plain path in turns
    (CUDA events; the median of each)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 2)).to(device)

    def plain_fwd():
        with kernels.plain():
            model(x)
    k_ts, p_ts = [], []
    with torch.no_grad(), compute_dtype(dtype):
        model(x)
        plain_fwd()
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    log(f'[forward] b={BATCH} {dtype} whole forward: kernel path {k_ms:.2f} ms '
        f'({1e3 * BATCH / k_ms:.1f} clouds/s), plain path {p_ms:.2f} ms '
        f'({1e3 * BATCH / p_ms:.1f} clouds/s); median of {reps} turns')
    return {'kernel_ms': k_ms, 'plain_ms': p_ms, 'kernel_runs_ms': k_ts,
            'plain_runs_ms': p_ts}


def phase_eval(dtype='fp32'):
    """A main path: run_modelnet eval on a synthetic test tree, in fp32, or
    in the bf16 production mode (this slice's)."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tree = os.path.join(WORK_DIR, 'modelnet')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=0, n_test=16,
                                 n_points=N_POINTS, seed=0, splits=('testR',))
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', str(BATCH),
            '--compute-dtype', dtype, '--model-dir',
            os.path.join(WORK_DIR, 'runs')]
    try:
        kernels.reset_counts()
        t0 = time.time()
        trainer = run_modelnet.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.counts()
    finally:
        so3conv.set_compute_dtype('fp32')
    trainer.logger.close()
    n_batches = len(trainer.eval_logits)
    logits = torch.cat(trainer.eval_logits)
    log(f'[eval] run_modelnet eval --compute-dtype {dtype}: {n_batches} '
        f'batches of {BATCH}, logits {tuple(logits.shape)} {logits.dtype}, '
        f'accuracy {trainer.test_accs[-1]:.2f}%, wall {wall:.2f} s (data and '
        f'setup included); kernel launches {counts}')
    assert n_batches >= 2 and logits.shape == (n_batches * BATCH, 40)
    assert torch.isfinite(logits).all(), 'non-finite eval logits'
    per = EVAL_PER_BATCH if dtype == 'fp32' else BF16_EVAL_PER_BATCH
    expect = {n: k * n_batches for n, k in per.items()}
    assert counts == expect, (counts, expect)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, n_batches


# kernel launches of one eval batch, and of one train step: the forward's,
# plus the backward's: intra df runs the forward intra kernel on the inverse
# adjacency (7 more), dTable and dW at the 6 inter layers with a feature
# table, intra dW at all 7; the layer-0 ones conv has no backward (its VJP is
# zero: F depends on the coordinates only)
_NO_BF16 = {'intra_conv_prenorm': 0, 'moments': 0, 'grouped_conv': 0,
            'grouped_conv_tail': 0}
EVAL_PER_BATCH = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
                  'inter_conv_dtable': 0, 'inter_conv_dw': 0,
                  'intra_conv': 7, 'intra_conv_dw': 0, **_NO_BF16}
TRAIN_PER_STEP = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
                  'inter_conv_dtable': 6, 'inter_conv_dw': 6,
                  'intra_conv': 14, 'intra_conv_dw': 7, **_NO_BF16}
# the bf16 production eval: every intra layer runs the prenorm form and its
# InstanceNorm statistics through moments; layers 1-6 end in the fused tail
# (layer 0's rank-1 skip keeps the unfused one); the head's mlp conv is the
# grouped conv
BF16_EVAL_PER_BATCH = {'fps': 1, 'ball_query': 7, 'ones_conv': 1,
                       'inter_conv': 6, 'inter_conv_dtable': 0,
                       'inter_conv_dw': 0, 'intra_conv': 0,
                       'intra_conv_dw': 0, 'intra_conv_prenorm': 7,
                       'moments': 7, 'grouped_conv': 1,
                       'grouped_conv_tail': 6}
BF16_FWD = ('fps', 'ball_query', 'ones_conv', 'inter_conv',
            'intra_conv_prenorm', 'moments', 'grouped_conv_tail',
            'grouped_conv')
# the kernels whose bf16 calls are compared here (fps and ball_query take
# the same fp32 coordinates in both modes: compared in the fp32 phase)
BF16_COMPARED = BF16_FWD[2:]


def phase_bf16_kernels(model, device):
    """Each kernel call of a b=32 bf16 forward against its plain version on
    the same inputs (normwise <= 4e-3 for bf16 outputs, <= 1e-5 for the
    moments' fp32 sums), timed, with torch.addmm beside the grouped conv."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)

    def run():
        with torch.no_grad():
            model(x)
    with compute_dtype('bf16'):
        calls = capture_calls(BF16_FWD, run)
    entries = {k.name: k for k in kernels.KERNELS}
    n_calls = {n: sum(1 for c in calls if c[0] == n) for n in BF16_FWD}
    results = {n: [] for n in BF16_COMPARED}
    failures = []
    torch.set_grad_enabled(False)
    for name, args in calls:
        if name not in BF16_COMPARED:
            continue
        # model layer: the inter conv and the fused tail start at layer 1
        # (layer 0 runs the ones conv and the unfused tail); the grouped
        # conv's one call is the head's
        layer = len(results[name]) + (1 if name in ('inter_conv',
                                                    'grouped_conv_tail')
                                      else 0)
        kern_fn = getattr(entries[name].module, name)
        plain_fn = getattr(entries[name].module, entries[name].plain)
        got, want = kern_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        if name == 'moments':
            rel = max(rel_err(g, w) for g, w in zip(got, want))
            max_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            tol = 1e-5
            finite = all(bool(torch.isfinite(g).all()) for g in got)
        else:
            rel = rel_err(got, want)
            max_err = float((got.float() - want.float()).abs().max())
            tol = 1e-5 if got.dtype == torch.float32 else 4e-3
            finite = bool(torch.isfinite(got).all())
        ok = rel <= tol and finite
        k_ms = time_ms(lambda: kern_fn(*args))
        p_ms = time_ms(lambda: plain_fn(*args))
        row = {'layer': layer, 'shape': _shape_desc(name, args),
               'max_abs_err': max_err, 'rel_norm_err': rel, 'ms': k_ms,
               'plain_ms': p_ms, 'ok': ok}
        row['bytes_ms'], row['ops_ms'] = bound_ms(name, args, got)
        lib = ''
        if name == 'grouped_conv':
            xx, W, bias = args
            x2, b2 = xx.reshape(-1, W.shape[0]), bias.to(xx.dtype)
            row['library_ms'] = time_ms(lambda: torch.addmm(b2, x2, W))
            lib = f' addmm_ms={row["library_ms"]:.4f}'
        log(f'[bf16] {name} L{layer} ({row["shape"]}): max_abs_err='
            f'{max_err:.3e} rel_norm_err={rel:.3e} [rel_norm<={tol:.0e}] '
            f'kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}{lib} bound_ms='
            f'{max(row["bytes_ms"], row["ops_ms"]):.4f} '
            f'{"OK" if ok else "FAIL"}')
        results[name].append(row)
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    torch.set_grad_enabled(True)
    if n_calls != {n: BF16_EVAL_PER_BATCH[n] for n in BF16_FWD}:
        failures.append(f'bf16 forward calls {n_calls}')
    if failures:
        raise AssertionError(f'bf16 kernel comparisons failed: {failures}')
    return results


def _cosine(a, b):
    import torch
    return torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                 dim=-1)


def phase_bf16_model(model, device):
    """b=8 bf16 logits, kernel path vs plain path (per-sample cosine >=
    0.9999); b=32 bf16 vs fp32 kernel paths (minimum cosine >= 0.999)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x8 = torch.from_numpy(synthetic_batch(8, N_POINTS, SEED + 1)).to(device)
    x32 = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 2)).to(
        device)
    with torch.no_grad():
        with compute_dtype('bf16'):
            k8 = model(x8)[0]
            with kernels.plain():
                p8 = model(x8)[0]
            k32 = model(x32)[0]
        f32 = model(x32)[0]
    torch.cuda.synchronize()
    cos8, cos32 = _cosine(k8, p8), _cosine(k32, f32)
    log(f'[bf16-model] b=8 bf16 logits kernel vs plain path: min cosine '
        f'{float(cos8.min()):.7f} (>= 0.9999), max abs diff '
        f'{float((k8 - p8).abs().max()):.3e}; b={BATCH} bf16 vs fp32 kernel '
        f'path: min cosine {float(cos32.min()):.7f} (>= 0.999), mean '
        f'{float(cos32.mean()):.7f}')
    assert k8.dtype == torch.float32 and torch.isfinite(k8).all()
    assert torch.isfinite(k32).all()
    assert float(cos8.min()) >= 0.9999, cos8
    assert float(cos32.min()) >= 0.999, cos32
    return {'b8_kernel_vs_plain_min_cos': float(cos8.min()),
            'b32_bf16_vs_fp32_min_cos': float(cos32.min())}


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
        b_ms, o_ms = bound_ms(name, args, got)
        shape = tuple(want.shape)
        log(f'[backward] {name} L{layer} (out {shape}): max_abs_err='
            f'{max_err:.3e} rel_norm_err={rel:.3e} [rel_norm<={tol:.0e}] '
            f'kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms='
            f'{max(b_ms, o_ms):.4f} {"OK" if ok else "FAIL"}')
        results[name].append({'layer': layer, 'shape': str(shape),
                              'max_abs_err': max_err, 'rel_norm_err': rel,
                              'ms': k_ms, 'plain_ms': p_ms, 'bytes_ms': b_ms,
                              'ops_ms': o_ms, 'ok': ok})
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
        torch.cuda.empty_cache()
        bf16_results = phase_bf16_kernels(model, device)
        torch.cuda.empty_cache()
        bf16_model = phase_bf16_model(model, device)
        bf16_forward = phase_forward_time(model, device, dtype='bf16')
        del model
        torch.cuda.empty_cache()
        eval_counts, n_batches = phase_eval()
        bf16_counts, bf16_batches = phase_eval('bf16')
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
        # the numbers of the path that runs the kernel: this slice's bf16
        # eval for the production kernels, the fp32 forward (b=32) or the
        # train step's backward (b=12) for the others; `launches` from the
        # bf16 eval entry run, else from the fp32 train entry run
        rows = bf16_results.get(k.name) or results[k.name]
        rec = {'name': k.name, 'route': 'cuda', 'source': k.source,
               'replaces': k.replaces,
               'launches': bf16_counts[k.name] or counts[k.name]}
        rec.update(_aggregate(rows))
        rec['phase'] = ('bf16 forward b=32' if k.name in bf16_results else
                        'fp32 forward b=32' if k.name in FWD else
                        'fp32 train step b=12')
        if k.name in bf16_results and k.name in results:
            rec['fp32'] = _aggregate(results[k.name])
        if k.name == 'intra_conv':
            # df runs this kernel (b=12 train step); ms above: b=32 forward
            rec['df'] = _aggregate(results['intra_conv_df'])
            rec['max_abs_err'] = max(rec['max_abs_err'],
                                     rec['df']['max_abs_err'])
        rec.update({'bf16_eval_launches': bf16_counts[k.name],
                    'eval_launches': eval_counts[k.name],
                    'train_entry_launches': counts[k.name]})
        summary.append(rec)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_results.json'), 'w') as f:
        json.dump({'card': card, 'device': torch.cuda.get_device_name(0),
                   'torch': torch.__version__, 'cuda': torch.version.cuda,
                   'batch': BATCH, 'train_batch': TRAIN_BATCH,
                   'per_layer': results, 'bf16_per_layer': bf16_results,
                   'model_b8_max_abs_err': model_err, 'bf16_model': bf16_model,
                   'forward_b32': forward, 'bf16_forward_b32': bf16_forward,
                   'train_step_b12': train_step,
                   'eval_batches': n_batches, 'eval_launches': eval_counts,
                   'bf16_eval_batches': bf16_batches,
                   'bf16_eval_launches': bf16_counts,
                   'train_launches': counts, 'train_entry_wall_s': train_wall,
                   'kernels': summary, 'seconds': time.time() - t_start},
                  f, indent=1)
    log(f'[done] {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': summary}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
