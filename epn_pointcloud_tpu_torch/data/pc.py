"""Host-side point-cloud utilities the ModelNet40 and 3DMatch loaders need
(counterpart of part of ``epn_pointcloud_tpu/data/pc.py``)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as sciR

from ..ops.rotation import R_from_euler_np


def uniform_resample_index_np(pc: np.ndarray, n_sample: int,
                              rng=None) -> np.ndarray:
    """Down: choice without replacement; up: arange + choice with
    replacement."""
    rng = rng or np.random
    n_point = pc.shape[0]
    if n_point >= n_sample:
        return rng.choice(n_point, n_sample, replace=False)
    idx = rng.choice(n_point, n_sample - n_point, replace=True)
    return np.concatenate([np.arange(n_point), idx], axis=0)


def uniform_resample_np(pc: np.ndarray, n_sample: int, rng=None):
    """(idx, pc[idx]) for n_sample resampled points."""
    idx = uniform_resample_index_np(pc, n_sample, rng)
    return idx, pc[idx]


def normalize_np(pc):
    """pc [3, p]: center, then divide by the max point norm."""
    pc = pc - pc.mean(axis=1, keepdims=True)
    var = np.sqrt((pc ** 2).sum(axis=0, keepdims=True))
    return pc / var.max(axis=1, keepdims=True)


def rotate_point_cloud(data, R=None, max_degree=None, rng=None):
    """Rotate data [n, 3] (or None: the rotation alone) by R (a matrix or
    Euler angles); without R by Euler angles of whole degrees below
    ``max_degree`` (one draw of three from ``rng``), or else by a random
    SO(3) rotation (drawn from ``rng`` where it is a RandomState); returns
    (rotated [n, 3] or None, R [3, 3]). ``rng`` defaults to numpy's global
    state (JAX ``data/pc.py:53-76``)."""
    rng = rng or np.random
    if R is None:
        if max_degree is not None:
            R = rng.randint(0, max_degree, 3) * np.pi / 180.0
        else:
            R = sciR.random(random_state=rng if isinstance(
                rng, np.random.RandomState) else None).as_matrix()
    if isinstance(R, list) or np.asarray(R).ndim == 1:
        rotation_matrix = R_from_euler_np(np.asarray(R))
    else:
        R = np.asarray(R)
        assert R.shape[0] >= 3 and R.shape[1] >= 3
        rotation_matrix = R[:3, :3]
    if data is None:
        return None, rotation_matrix
    rotated = (rotation_matrix @ data.reshape(-1, 3).T).T
    return rotated, rotation_matrix


def voxel_downsample_np(pc: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid downsample: the centroid of each occupied voxel, voxels in
    the order of their integer keys (the JAX package's numpy path; its
    compiled host op orders and sums differently)."""
    keys = np.floor(pc / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inv, pc)
    return (sums / counts[:, None]).astype(pc.dtype)
