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
    # the same (the cloud in registers)
    'epn_fps_reg': [_P, _P, _I, _I, _I, _F, _P],
    # query, support, out_idx, b, m, n, n_sample, r2, stream
    'epn_ball_query': [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # the same (lanes a query)
    'epn_ball_query_warp': [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # gx, idx, table, rk, k2, w, out, b, p2, nn, q, na, k, c, d, sigma,
    # bf16, stream
    'epn_inter_conv': [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # gx, idx, table, rk, k2, w, out, b, p2, nn, q, na, k, c, d, sigma,
    # stream (bf16 on tensor cores)
    'epn_inter_conv_mma': [_P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # the same (fp32 on the CUDA cores)
    'epn_inter_conv_fwd_f32': [_P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # gx, idx, table, rk, k2, f, b, p2, nn, q, na, k, c, sigma, bf16, stream
    'epn_inter_conv_f': [_P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # gx, idx, table, rk, k2, f, b, p2, nn, q, na, k, c, sigma, stream (bf16
    # on tensor cores)
    'epn_inter_conv_f_mma': [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # gx, idx, table, rk, k2, f, b, p2, nn, q, na, k, c, sigma, stream (fp32
    # on the CUDA cores)
    'epn_inter_conv_f_f32': [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # gx, idx, rk, k2, df, d_table, b, p2, nn, q, na, k, c, sigma, bf16,
    # stream
    'epn_inter_conv_dg': [_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # f, trace_idx, w, ss, out, b, p, na, k, c, d, ss_stride, slope, bf16,
    # stream
    'epn_intra_conv': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _P],
    # f, trace_idx, w, ss, out, b, p, na, k, c, d, ss_stride, slope, stream
    # (bf16 on tensor cores)
    'epn_intra_conv_mma': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _F, _P],
    # f, trace_idx, w, ss (null), out, b, p, na, k, c, d, ss_stride, stream
    # (fp32 on the CUDA cores)
    'epn_intra_conv_f32': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    # gx, rk, k2, out, b, p2, nn, na, k, sigma, bf16, stream
    'epn_ones_conv': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, sum, sumsq, b, rows, lanes, bf16, stream
    'epn_moments': [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, bias, out, rows, c, d, bf16, stream
    'epn_grouped_conv': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, bias, ssk, y, ssm, out, b, p, na, c, d, ssk_stride, ssm_stride,
    # slope, bf16, stream
    'epn_grouped_conv_tail': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P],
    # gx, idx, rk, k2, w, dout, d_table, b, p2, nn, q, na, k, c, d, sigma,
    # bf16, stream
    'epn_inter_conv_bwd_table': [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # gx, idx, rk, k2, w, dout, d_table, b, p2, nn, q, na, k, c, d, sigma,
    # stream (bf16 on tensor cores)
    'epn_inter_conv_bwd_table_mma': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _F, _P],
    # gx, idx, rk, k2, df, d_table, b, p2, nn, q, na, k, c, sigma, stream
    # (bf16 on tensor cores)
    'epn_inter_conv_dg_mma': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P],
    # gx, idx, rk, k2, w, dout, d_table, b, p2, nn, q, na, k, c, d, sigma,
    # w_t (workspace), stream (fp32 on the CUDA cores)
    'epn_inter_conv_bwd_table_f32': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _F, _P, _P],
    # gx, idx, rk, k2, df, d_table, b, p2, nn, q, na, k, c, sigma, stream
    # (fp32 on the CUDA cores)
    'epn_inter_conv_dg_f32': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P],
    # gx, idx, table, rk, k2, dout, ws, d_w, b, p2, nn, q, na, k, c, d,
    # sigma, splits, bf16, stream
    'epn_inter_conv_bwd_w': [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # gx, idx, table, rk, k2, dout, ws, d_w, b, p2, nn, q, na, k, c, d,
    # sigma, splits, stream (bf16 on tensor cores)
    'epn_inter_conv_bwd_w_mma': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _I, _P],
    # gx, idx, table, rk, k2, dout, ws, d_w, b, p2, nn, q, na, k, c, d,
    # sigma, splits, bn, stream (fp32 on the CUDA cores)
    'epn_inter_conv_bwd_w_f32': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # f, trace_idx, ss, dout, ws, d_w, b, p, na, k, c, d, ss_stride, slope,
    # splits, bf16, stream
    'epn_intra_conv_bwd_w': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _I, _P],
    # f, trace_idx, ss, dout, ws, d_w, b, p, na, k, c, d, ss_stride, slope,
    # splits, rows_per_split, stream (bf16 on tensor cores)
    'epn_intra_conv_bwd_w_mma': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _P],
    # f, trace_idx, ss (null), dout, ws, d_w, b, p, na, k, c, d, ss_stride,
    # splits, rows_per_split, stream (fp32 on the CUDA cores)
    'epn_intra_conv_bwd_w_f32': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P],
    # dout, inv_idx, w_t, x, ss, df, ws, d_scale, d_shift, b, p, na, k, c, d,
    # ss_batch, slope, bf16, stream
    'epn_intra_conv_prenorm_df': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _F, _I, _P],
    # dout, inv_idx, w_t, x, ss, df, ws, d_scale, d_shift, b, p, na, k, c, d,
    # ss_batch, slope, stream (bf16 on tensor cores)
    'epn_intra_conv_prenorm_df_mma': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _I, _F, _P],
    # x, w, dout, dx, ws, dwb, rows, c, d, splits, parts, bf16, stream
    'epn_grouped_conv_bwd': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P],
}

_lock = threading.Lock()
_lib = None
build_log = ''
lib_path = ''  # the loaded library's file, once built


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


def compile_alone(csrc: str, source: str, out_dir: str, sub=None):
    """Start nvcc on one ``source`` of the directory ``csrc`` (this tree's
    or an earlier one's), copied to ``out_dir``, into a shared library
    there; ``sub``: (text in the source, its replacement), which raises
    when the source does not hold the text. Returns (process, library
    path): the caller waits on the process and loads the library with its
    own signatures. For the harnesses that time variants of a kernel.
    ``sub`` may also be a list of such pairs, applied in turn."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    src_path = os.path.join(out_dir, source)
    if sub is not None:
        with open(src_path) as f:
            src = f.read()
        for old, new in ([sub] if isinstance(sub[0], str) else sub):
            if old not in src:
                raise RuntimeError(f'{out_dir}: {old!r} not in {source}')
            src = src.replace(old, new)
        with open(src_path, 'w') as f:
            f.write(src)
    so = os.path.join(out_dir, 'lib.so')
    cmd = [_nvcc()] + ARCH_FLAGS + NVCC_FLAGS + ['-shared', '-o', so, src_path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log, lib_path
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
        _lib, lib_path = lib, so
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
    contiguous, 16-byte aligned tensor of that dtype and shape on ``dev``."""
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'{kernel}: {name} must be {dt} {shape} on '
                             f'{dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f'{kernel}: {name} must be contiguous and '
                             f'16-byte aligned')


def n_splits(tiles: int, row_tiles: int, target_blocks: int = 528) -> int:
    """Row ranges of a reduction over rows: enough blocks (tiles x splits)
    to fill the card ~4 blocks an SM (132 SMs), at most one a row tile."""
    return max(1, min(row_tiles, -(-target_blocks // max(tiles, 1))))


def dtype_flag(dtype, kernel: str) -> int:
    """The ``bf16`` flag of the C entry points for a kernel's element type:
    0 for fp32, 1 for bf16; any other type is refused."""
    import torch
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{kernel}: fp32 or bf16 only, got {dtype}')
    return int(dtype == torch.bfloat16)


# The activations the kernels apply (the prenorm intra conv, its backward
# and the fused tail), each the leaky ReLU of a slope with the mask u > 0
# (``epn::leaky``, csrc/elem.cuh), which the kernels take as a launch
# argument: the leaky ReLU's 0.01 and the ReLU's 0 (whose gradient at 0 is
# 0, as jax.nn.relu's).
LEAKY_SLOPE = 0.01
ACT_SLOPES = {'leaky_relu': LEAKY_SLOPE, 'relu': 0.0}


def leaky(u, slope: float = LEAKY_SLOPE):
    """The leaky ReLU of ``slope`` with the kernels' mask ``u > 0``."""
    import torch
    return torch.where(u > 0, u, slope * u)


def widen(t):
    """t in the type its plain version computes in: bf16 -> fp32; fp32 (and
    the fp64 of gradient checks) unchanged."""
    import torch
    return t.float() if t.dtype == torch.bfloat16 else t
