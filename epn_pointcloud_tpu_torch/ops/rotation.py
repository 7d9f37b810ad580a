"""Host-side (numpy) rotation utilities used by the data loaders.

Counterpart of the part of ``epn_pointcloud_tpu/ops/rotation.py`` that the
ModelNet40 test loader and the synthetic 3DMatch tree call.
"""

from __future__ import annotations

import numpy as np


def rand_rotation_matrix(rng: np.random.RandomState) -> np.ndarray:
    """Uniform random rotation by Arvo's method from three numbers drawn
    from ``rng``."""
    theta, phi, z = rng.uniform(size=(3,))
    theta = theta * 2.0 * np.pi
    phi = phi * 2.0 * np.pi
    z = z * 2.0
    r = np.sqrt(z)
    V = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    R = np.array(((ct, st, 0), (-st, ct, 0), (0, 0, 1)))
    return (np.outer(V, V) - np.eye(3)).dot(R)


def R_from_euler_np(angles: np.ndarray) -> np.ndarray:
    """Rz(c) @ Ry(b) @ Rx(a) from angles [a, b, c]."""
    a, b, c = angles
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                   [0, 0, 1]])
    return Rz @ Ry @ Rx


def rotation_distance_np(r0: np.ndarray, r1: np.ndarray):
    """Trace-based rotation distance of one rotation r0 [3, 3] to a set of
    rotations r1 [n, 3, 3] (usually the anchors). Returns (traces, argmax
    idx, r1^T @ r0)."""
    diff_r = np.einsum('nji,jk->nik', r1, r0)
    traces = np.einsum('nii->n', diff_r)
    return traces, int(np.argmax(traces)), diff_r
