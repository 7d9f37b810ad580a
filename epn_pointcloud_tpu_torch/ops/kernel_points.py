"""Spherical kernel-point sets for the SO(3) inter convolution.

Counterpart of ``epn_pointcloud_tpu/ops/kernel_points.py``: under the
native anchor convention, deterministic programmatic sets of 24 / 30 / 66
points for ``kernel_size`` 1 / 2 / 3; under the reference convention the
original EPN's kpsphere{24,30,66}.ply coordinates (vendored,
``ops/ref_convention.py``). Either is scaled so the largest point norm
equals the requested radius. The conv layers pass
``KERNEL_CONDENSE_RATIO * radius``.
"""

from __future__ import annotations

import functools

import numpy as np

KERNEL_CONDENSE_RATIO = 0.7
KERNEL_SIZE_TO_NPOINTS = {1: 24, 2: 30, 3: 66}


def spherical_kernel_points_grid(radius: float, kernel_size: int,
                                 multiplier: int = 3) -> np.ndarray:
    """Concentric lat/long grids (the 66-point family)."""
    rrange = np.linspace(0, radius, kernel_size, dtype=np.float32)
    kps = []
    for ridx, r_i in enumerate(rrange):
        asize = ridx * multiplier + 1
        bsize = ridx * multiplier + 1
        alpharange = np.linspace(0, 2 * np.pi, asize, endpoint=False,
                                 dtype=np.float32)
        betarange = np.linspace(0, np.pi, bsize, endpoint=True,
                                dtype=np.float32)
        xs = r_i * np.cos(alpharange[:, None]) * np.sin(betarange[None])
        ys = r_i * np.sin(alpharange[:, None]) * np.sin(betarange[None])
        zs = r_i * np.cos(betarange)[None].repeat(asize, axis=0)
        kps.append(np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)],
                            axis=1))
    return np.concatenate(kps, axis=0)


def _repulsion_shell(n: int, seed: int) -> np.ndarray:
    """n deterministic well-separated unit vectors (Thomson-style descent)."""
    rng = np.random.RandomState(seed)
    p = rng.randn(n, 3)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    for _ in range(2000):
        diff = p[:, None] - p[None]
        d2 = (diff ** 2).sum(-1) + np.eye(n)
        force = (diff / (d2 ** 1.5)[..., None]).sum(1)
        p = p + 0.001 * force
        p /= np.linalg.norm(p, axis=1, keepdims=True)
    key = np.round(p, 6)
    order = np.lexsort((key[:, 0], key[:, 1], key[:, 2]))
    return p[order]


@functools.lru_cache(maxsize=None)
def _unit_kernel_family(n_points: int,
                        convention: str = 'native') -> np.ndarray:
    """Kernel points at unit outer radius, [n_points, 3] float32; under
    'reference' the exact ply coordinates, so weights trained by the
    original EPN see the kernel layout they were trained with."""
    if convention == 'reference':
        from . import ref_convention
        return ref_convention.ref_kernel_points(n_points)
    if n_points == 66:
        return spherical_kernel_points_grid(1.0, 3, 3).astype(np.float32)
    if n_points == 24:
        shell = _repulsion_shell(23, seed=24)
        return np.concatenate([np.zeros((1, 3)), shell], 0).astype(np.float32)
    if n_points == 30:
        inner = _repulsion_shell(2, seed=302) * 0.53
        outer = _repulsion_shell(27, seed=301)
        return np.concatenate([np.zeros((1, 3)), inner, outer],
                              0).astype(np.float32)
    raise ValueError(f'unsupported kernel point count {n_points}')


def get_spherical_kernel_points(radius: float, kernel_size: int) -> np.ndarray:
    """Kernel points of the anchor convention in force, scaled so the max
    norm equals ``radius``: under 'reference' in the original EPN's
    operation order (pts * radius / r), for bit parity."""
    assert 0 < kernel_size <= 3
    from . import icosahedron
    conv = icosahedron.get_convention()
    pts = _unit_kernel_family(KERNEL_SIZE_TO_NPOINTS[kernel_size], conv)
    r = np.sqrt((pts ** 2).sum(1).max())
    if conv == 'reference':
        return (pts * radius / r).astype(np.float32)
    return (pts * (radius / r)).astype(np.float32)
