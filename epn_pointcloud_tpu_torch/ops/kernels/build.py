"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links the objects into a shared library with a plain C
interface, which is loaded through ``ctypes``. The library lands in
``<checkout>/build/`` (git-ignored) under a name that carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
from disk. Nothing here runs at import time: the first kernel launch builds.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p``, integers as ``c_int`` and floats as ``c_float``, launches on
that stream, allocates nothing, does not synchronize, and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build')

ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-lineinfo']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures: name -> argtypes (every entry returns cudaError_t as int)
SIGNATURES = {
    # xyz, out_idx, b, n, n_sample, shadow_eps, stream
    'epn_fps': [_P, _P, _I, _I, _I, _F, _P],
    # query, support, out_idx, b, m, n, n_sample, r2, stream
    'epn_ball_query': [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # gx, idx, table, rk, k2, w, out, b, p2, nn, q, na, k, c, d, sigma, stream
    'epn_inter_conv': [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # f, trace_idx, w, out, b, p, na, k, c, d, stream
    'epn_intra_conv': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # gx, idx, rk, k2, w, dout, d_table, b, p2, nn, q, na, k, c, d, sigma,
    # stream
    'epn_inter_conv_bwd_table': [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # gx, idx, table, rk, k2, dout, ws, d_w, b, p2, nn, q, na, k, c, d,
    # sigma, splits, stream
    'epn_inter_conv_bwd_w': [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # f, trace_idx, dout, ws, d_w, b, p, na, k, c, d, splits, stream
    'epn_intra_conv_bwd_w': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P],
}

_lock = threading.Lock()
_lib = None
build_log = ''


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(('.cu', '.cuh')))


def _nvcc() -> str:
    cand = shutil.which('nvcc')
    if cand is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        cand = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(cand):
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME or put nvcc on PATH)')
    return cand


def _compile(srcs, so: str) -> str:
    """One nvcc a source, all running at once, then one link into ``so``;
    returns the compilers' output (ptxas register and spill lines)."""
    nvcc = _nvcc()
    tag = f'{so}.{os.getpid()}'
    objs = [f'{tag}.{os.path.basename(s)}.o' for s in srcs]
    procs = []
    try:
        for s, o in zip(srcs, objs):
            procs.append(subprocess.Popen(
                [nvcc] + ARCH_FLAGS + NVCC_FLAGS + ['-c', s, '-o', o],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for s, p in zip(srcs, procs):
            logs.append(p.communicate()[0])
            if p.returncode != 0:
                failed.append(os.path.basename(s))
        log = ''.join(logs)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        res = subprocess.run([nvcc] + ARCH_FLAGS + ['-shared', '-o',
                                                    f'{tag}.tmp'] + objs,
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n{log}')
        os.replace(f'{tag}.tmp', so)
        return log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256()
        for s in srcs:
            with open(s, 'rb') as f:
                h.update(os.path.basename(s).encode() + f.read())
        h.update(' '.join(ARCH_FLAGS + NVCC_FLAGS).encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f'libepn_kernels_{h.hexdigest()[:16]}.so')
        if not os.path.exists(so):
            build_log = _compile([s for s in srcs if s.endswith('.cu')], so)
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise on a CUDA launch error."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(kernel: str, dev, want: dict) -> None:
    """Raise unless every operand ``name: (tensor, dtype, shape)`` is a
    contiguous tensor of that dtype and shape on ``dev``."""
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'{kernel}: {name} must be {dt} {shape} on '
                             f'{dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{kernel}: {name} must be contiguous')


def n_splits(tiles: int, row_tiles: int, target_blocks: int = 528) -> int:
    """Row ranges of a reduction over rows: enough blocks (tiles x splits)
    to fill the card ~4 blocks an SM (132 SMs), at most one a row tile."""
    return max(1, min(row_tiles, -(-target_blocks // max(tiles, 1))))
