"""ModelNet40 loaders (counterpart of ``epn_pointcloud_tpu/data/modelnet40.py``
``Dataloader_ModelNet40``, ``Dataloader_ModelNet40Alignment`` and their
``DataLoader`` in a single process: the train split and the evaluation
splits).

On-disk contract: <root>/<category>/<split>/*.mat with keys 'pc' [n, 3],
'label', 'name' (and optionally a stored 'R'). Batches are numpy dicts.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.io as sio

from ..ops import icosahedron
from ..ops.rotation import label_relative_rotation_np, rotation_distance_np
from . import pc as pctk


def _mode_seed(seed: int, mode: str) -> int:
    """Stable per-split RNG seed (no salted ``hash()``)."""
    return int(seed) + sum(ord(c) for c in mode) % 1000


class DataLoader:
    """Synchronous batcher. With ``shuffle`` the order is drawn anew each
    epoch from a ``RandomState(seed)``; ``drop_last`` (default: shuffle)
    drops a short final batch, as the reference's train step does."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 2913, drop_last=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            items = [self.dataset[i] for i in idx]
            yield {k: _stack([it[k] for it in items]) for k in items[0]}


def _stack(vals):
    if isinstance(vals[0], np.ndarray):
        return np.stack(vals)
    if isinstance(vals[0], (int, np.integer, float, np.floating)):
        return np.asarray(vals)
    return vals


class Dataloader_ModelNet40:
    """ModelNet40 classification samples: train clouds resampled to
    ``input_num`` points, evaluation clouds as stored; normalized, and
    (unless --no-augmentation) rotated, by the stored R of an evaluation
    file if it has one and at random otherwise, with the nearest anchor's
    index as the rotation label."""

    def __init__(self, opt, mode):
        self.opt = opt
        self.mode = mode
        self.rng = np.random.RandomState(_mode_seed(opt.seed, self.mode))
        cats = sorted(os.listdir(opt.dataset_path))
        self.all_data = []
        for cat in cats:
            pattern = os.path.join(opt.dataset_path, cat, self.mode, '*.mat')
            self.all_data.extend(sorted(glob.glob(pattern)))

    def __len__(self):
        return len(self.all_data)

    def __getitem__(self, index):
        data = sio.loadmat(self.all_data[index])
        train = self.mode == 'train'
        pc = data['pc']
        if train:
            _, pc = pctk.uniform_resample_np(pc, self.opt.model.input_num,
                                             rng=self.rng)
        pc = pctk.normalize_np(pc.T).T

        R = np.eye(3)
        R_label = icosahedron.get_identity_index()
        if not self.opt.no_augmentation:
            stored = None if train else data.get('R')
            pc, R = pctk.rotate_point_cloud(pc, stored, rng=self.rng)
            _, R_label, _ = rotation_distance_np(R,
                                                 icosahedron.get_anchors())

        return {'pc': pc.astype(np.float32),
                'label': np.int64(np.asarray(data['label']).flatten()[0]),
                'fn': str(data['name'][0]),
                'R': np.asarray(R, dtype=np.float32),
                'R_label': np.int64(R_label)}


class Dataloader_ModelNet40Alignment:
    """Rotation-alignment pairs of the airplane category: each cloud
    resampled to ``input_num`` points and normalized is the target; the
    source is it under a random rotation T. Items: 'pc' [2, n, 3] (source,
    target), T, and per source anchor the target anchor 'R_label' [na] and
    the residual rotation 'R' [na, 3, 3]."""

    def __init__(self, opt, mode=None):
        self.opt = opt
        self.mode = opt.mode if mode is None else mode
        self.rng = np.random.RandomState(_mode_seed(opt.seed, self.mode))
        pattern = os.path.join(opt.dataset_path, 'airplane', self.mode,
                               '*.mat')
        self.all_data = sorted(glob.glob(pattern))

    def __len__(self):
        return len(self.all_data)

    def __getitem__(self, index):
        data = sio.loadmat(self.all_data[index])
        _, pc = pctk.uniform_resample_np(data['pc'], self.opt.model.input_num,
                                         rng=self.rng)
        pc = pctk.normalize_np(pc.T).T
        pc_src, T = pctk.rotate_point_cloud(pc, None, rng=self.rng)
        R, R_label = label_relative_rotation_np(
            icosahedron.get_anchors(self.opt.model.kanchor), T)
        return {'pc': np.stack([pc_src, pc]).astype(np.float32),
                'fn': str(data['name'][0]),
                'T': T.astype(np.float32),
                'R': R.astype(np.float32),
                'R_label': R_label.astype(np.int64)}
