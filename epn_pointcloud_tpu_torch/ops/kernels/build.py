"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile in one ``nvcc`` call into a shared library with a plain C
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
NVCC_FLAGS = ['-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v', '-lineinfo']

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
            tmp = f'{so}.{os.getpid()}.tmp'
            cmd = ([_nvcc()] + ARCH_FLAGS + NVCC_FLAGS + ['-o', tmp]
                   + [s for s in srcs if s.endswith('.cu')])
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                                   f'{build_log}')
            os.replace(tmp, so)
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
