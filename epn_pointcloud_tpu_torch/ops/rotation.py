"""Rotation utilities (counterpart of ``epn_pointcloud_tpu/ops/rotation.py``):
host-side numpy functions for the data loaders (the random rotation, Euler
angles, the anchor distance and the relative-rotation labels of the
alignment pairs), and the torch maps of the rotation regression loss (the
regressed quaternion / ortho6d / Euler sin-cos to a matrix, the weighted
chordal mean, the angle).
"""

from __future__ import annotations

import numpy as np
import torch


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


def label_relative_rotation_np(anchors: np.ndarray, T: np.ndarray):
    """Per-source-anchor relative-rotation targets of a pair under T:
    anchors [na, 3, 3], T [3, 3] -> (R_target [na, 3, 3], label [na]), with
    label[a] the target anchor b of the largest trace of anchors[a]^T T
    anchors[b] and R_target[a] that residual rotation."""
    T_from_anchors = np.einsum('abc,bj,ijk->aick', anchors, T, anchors)
    label = np.argmax(np.einsum('abii->ab', T_from_anchors), axis=1)
    R_target = T_from_anchors[np.arange(label.shape[0]), label]
    return R_target, label.astype(np.int64)


# ------------------------------------------------------------------ device

def acos_safe(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """arccos, continued linearly past |x| = 1 - eps (a finite gradient at
    +-1)."""
    sign = torch.sign(x)
    slope = float(np.arccos(1 - eps) / eps)
    return torch.where(
        x.abs() <= 1 - eps, torch.arccos(x.clamp(-1 + eps, 1 - eps)),
        torch.arccos(sign * (1 - eps)) - slope * sign * (x.abs() - 1 + eps))


def rotation_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """[b, 4] (w, x, y, z), normalized with a 1e-8 floor -> [b, 3, 3]."""
    q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-8)
    w, x, y, z = q.unbind(1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    m = torch.stack([
        1 - 2 * yy - 2 * zz, 2 * xy - 2 * zw, 2 * xz + 2 * yw,
        2 * xy + 2 * zw, 1 - 2 * xx - 2 * zz, 2 * yz - 2 * xw,
        2 * xz - 2 * yw, 2 * yz + 2 * xw, 1 - 2 * xx - 2 * yy], dim=1)
    return m.reshape(-1, 3, 3)


def rotation_from_ortho6d(o: torch.Tensor) -> torch.Tensor:
    """[b, 6] -> [b, 3, 3] by Gram-Schmidt; columns x, y, z."""
    def normalize(v):
        return v / v.norm(dim=1, keepdim=True).clamp(min=1e-8)
    x = normalize(o[:, 0:3])
    z = normalize(torch.linalg.cross(x, o[:, 3:6], dim=1))
    y = torch.linalg.cross(z, x, dim=1)
    return torch.stack([x, y, z], dim=2)


def rotation_from_euler_sin_cos(e: torch.Tensor) -> torch.Tensor:
    """[b, 6] (s1, c1, s2, c2, s3, c3) -> [b, 3, 3]."""
    s1, c1, s2, c2, s3, c3 = e.unbind(1)
    m = torch.stack([
        c2 * c3, -s2, c2 * s3,
        c1 * s2 * c3 + s1 * s3, c1 * c2, c1 * s2 * s3 - s1 * c3,
        s1 * s2 * c3 - c1 * s3, s1 * c2, s1 * s2 * s3 + c1 * c3], dim=1)
    return m.reshape(-1, 3, 3)


def so3_mean(Rs: torch.Tensor, weights=None) -> torch.Tensor:
    """Chordal L2 mean of rotations Rs [b, n, 3, 3] (weights [b, n]) ->
    [b, 3, 3]: U diag(1, 1, det(U V^T)) V^T of the SVD of the (weighted)
    sum. torch.linalg.svd returns V^T, as the JAX package's SVD does."""
    Ce = Rs.sum(dim=1) if weights is None else \
        (weights[:, :, None, None] * Rs).sum(dim=1)
    u, _, vt = torch.linalg.svd(Ce)
    dets = torch.linalg.det(u @ vt)
    D = torch.zeros_like(Ce)
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = dets
    return u @ D @ vt


def angle_from_R(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of matrices [..., 3, 3]."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    return acos_safe(0.5 * (tr - 1))


def mean_angular_error(pred_R: torch.Tensor, gt_R: torch.Tensor):
    """Per-element angle of pred_R gt_R^T, [b]."""
    return angle_from_R(torch.einsum('bij,bkj->bik', pred_R, gt_R))
