"""ModelNet40 test loader (counterpart of
``epn_pointcloud_tpu/data/modelnet40.py`` ``Dataloader_ModelNet40`` and its
single-process ``DataLoader``, evaluation splits only).

On-disk contract: <root>/<category>/<split>/*.mat with keys 'pc' [n, 3],
'label', 'name' (and optionally a stored 'R'). Batches are numpy dicts.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.io as sio

from ..ops import icosahedron
from ..ops.rotation import rotation_distance_np
from . import pc as pctk


def _mode_seed(seed: int, mode: str) -> int:
    """Stable per-split RNG seed (no salted ``hash()``)."""
    return int(seed) + sum(ord(c) for c in mode) % 1000


class DataLoader:
    """Synchronous batcher in dataset order; the last batch may be short."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            items = [self.dataset[i]
                     for i in range(s, min(s + self.batch_size, n))]
            yield {k: _stack([it[k] for it in items]) for k in items[0]}


def _stack(vals):
    if isinstance(vals[0], np.ndarray):
        return np.stack(vals)
    if isinstance(vals[0], (int, np.integer, float, np.floating)):
        return np.asarray(vals)
    return vals


class Dataloader_ModelNet40:
    """ModelNet40 classification samples of an evaluation split: clouds as
    stored, normalized, and (unless --no-augmentation) rotated, with the
    nearest anchor's index as the rotation label."""

    def __init__(self, opt, mode):
        if mode == 'train':
            raise NotImplementedError('the training split (resampling) is '
                                      'not ported')
        self.opt = opt
        self.mode = mode
        self.anchors = icosahedron.get_anchors()
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
        pc = pctk.normalize_np(data['pc'].T).T

        R = np.eye(3)
        R_label = icosahedron.get_identity_index()
        if not self.opt.no_augmentation:
            pc, R = pctk.rotate_point_cloud(pc, data.get('R'), rng=self.rng)
            _, R_label, _ = rotation_distance_np(R, self.anchors)

        return {'pc': pc.astype(np.float32),
                'label': np.int64(np.asarray(data['label']).flatten()[0]),
                'fn': str(data['name'][0]),
                'R': np.asarray(R, dtype=np.float32),
                'R_label': np.int64(R_label)}
