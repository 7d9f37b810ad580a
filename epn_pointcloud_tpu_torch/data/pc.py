"""Host-side point-cloud utilities the ModelNet40 test loader needs
(counterpart of part of ``epn_pointcloud_tpu/data/pc.py``)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as sciR

from ..ops.rotation import R_from_euler_np


def normalize_np(pc):
    """pc [3, p]: center, then divide by the max point norm."""
    pc = pc - pc.mean(axis=1, keepdims=True)
    var = np.sqrt((pc ** 2).sum(axis=0, keepdims=True))
    return pc / var.max(axis=1, keepdims=True)


def rotate_point_cloud(data, R, rng: np.random.RandomState):
    """Rotate data [n, 3] by R (a matrix or Euler angles), or by a random
    SO(3) rotation drawn from ``rng`` when R is None; returns
    (rotated [n, 3], R [3, 3])."""
    if R is None:
        R = sciR.random(random_state=rng).as_matrix()
    if isinstance(R, list) or np.asarray(R).ndim == 1:
        rotation_matrix = R_from_euler_np(np.asarray(R))
    else:
        R = np.asarray(R)
        assert R.shape[0] >= 3 and R.shape[1] >= 3
        rotation_matrix = R[:3, :3]
    rotated = (rotation_matrix @ data.reshape(-1, 3).T).T
    return rotated, rotation_matrix
