"""Synthetic ModelNet40-compatible data (copy of the ModelNet part of
``epn_pointcloud_tpu/data/synthetic.py``): writes a .mat tree with the real
data's on-disk contract, <root>/<cat>/<split>/*.mat with 'pc', 'label',
'name'.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as sio


def make_shape(rng: np.random.RandomState, n_points: int,
               kind: int) -> np.ndarray:
    """Distinguishable parametric shapes (sphere/cube/torus/...)."""
    t = rng.rand(n_points)
    u = rng.rand(n_points) * 2 * np.pi
    v = rng.rand(n_points) * np.pi
    if kind % 5 == 0:        # sphere surface
        pc = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u),
                       np.cos(v)], 1)
    elif kind % 5 == 1:      # cube surface
        pc = rng.rand(n_points, 3) * 2 - 1
        ax = rng.randint(0, 3, n_points)
        sgn = rng.randint(0, 2, n_points) * 2 - 1
        pc[np.arange(n_points), ax] = sgn
    elif kind % 5 == 2:      # torus
        r0, r1 = 1.0, 0.35
        pc = np.stack([(r0 + r1 * np.cos(v * 2)) * np.cos(u),
                       (r0 + r1 * np.cos(v * 2)) * np.sin(u),
                       r1 * np.sin(v * 2)], 1)
    elif kind % 5 == 3:      # cylinder
        pc = np.stack([np.cos(u), np.sin(u), 2 * t - 1], 1)
    else:                    # two clusters
        pc = 0.3 * rng.randn(n_points, 3)
        pc[n_points // 2:, 0] += 1.5
    if kind >= 5:
        # categories beyond the 5 base families get deterministic per-kind
        # shape parameters (anisotropic scaling + a second displaced
        # component), so any n_cats stays mutually distinguishable — and,
        # under the rotated test protocol, only via rotation-invariant
        # features (the anisotropy axes are randomized per sample by testR)
        prng = np.random.RandomState(1000 + kind)
        scale = 0.4 + 1.2 * prng.rand(3)
        pc = pc * scale[None, :]
        n2 = n_points // 3
        sub = make_shape(np.random.RandomState(rng.randint(1 << 31)),
                         n2, (kind // 5 + kind) % 5)
        off = prng.randn(3) * 1.2
        pc[:n2] = 0.5 * sub + off[None, :]
    pc = pc + 0.02 * rng.randn(n_points, 3)
    return pc.astype(np.float32)


def make_modelnet_tree(root: str, n_cats: int = 4, n_train: int = 8,
                       n_test: int = 4, n_points: int = 2048,
                       seed: int = 0, splits=('train', 'test', 'testR')):
    """Create a synthetic ModelNet-like .mat tree (same files, for the same
    arguments, as the JAX package's generator with its default shapes).
    Category 0 is named 'airplane'."""
    rng = np.random.RandomState(seed)
    names = ['airplane'] + [f'cat{i:02d}' for i in range(1, n_cats)]
    for ci, cat in enumerate(names):
        for split in splits:
            n = n_train if split == 'train' else n_test
            d = os.path.join(root, cat, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                pc = make_shape(rng, n_points, ci)
                data = {'pc': pc, 'label': np.array([[ci]]),
                        'name': f'{cat}_{split}_{i:04d}'}
                sio.savemat(os.path.join(d, f'{cat}_{i:04d}.mat'), data)
    return root
