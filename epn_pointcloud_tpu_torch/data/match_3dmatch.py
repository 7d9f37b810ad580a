"""3DMatch training loader (counterpart of ``epn_pointcloud_tpu/
data/match_3dmatch.py:32-208``: ``radius_ball_search``,
``PointCloudPairSampler``, ``FragmentLoader``).

On-disk contract: <root>/fused_fragments/<scene>/<seq>/cloud_bin_N.ply (with
its pose as cloud_bin_N.pose.npy or cloud_bin_N_pose.txt) and
<root>/<kptname>/<scene>/<seq>/cloud_bin_A-cloud_bin_B.npy keypoint index
pairs. Fragments are voxel-downsampled (``data/pc.voxel_downsample_np``)
and searched with scipy's KDTree: the JAX package's numpy / scipy path. Its
compiled host ops (``epn_pointcloud_tpu/native``), which it takes when they
load, give other voxel arrays and radius lists, so the port follows the
fallback.
"""

from __future__ import annotations

import glob
import os
import re
from collections import namedtuple

import numpy as np
from scipy.spatial import KDTree

from ..ops.ply import load_ply
from . import pc as pctk

Kptmeta = namedtuple('Kptmeta', 'indices, id, pathA, pathB, poseA, poseB')


def _parse_pair_name(name: str, suffix: str = '.npy'):
    """'cloud_bin_A-cloud_bin_B<suffix>' -> (A, B), else None."""
    m = re.match(r'cloud_bin_(\d+)-cloud_bin_(\d+)' + re.escape(suffix), name)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def radius_ball_search(points: np.ndarray, kpt_indices: np.ndarray,
                       search_radius: float, voxel_size: float):
    """The points of the voxel-downsampled cloud within search_radius of
    each keypoint, a patch a keypoint; a keypoint with at most one point in
    its ball gets a zero patch of 1024 points."""
    keypoints = points[kpt_indices]
    pc_down = pctk.voxel_downsample_np(points, voxel_size)
    results = KDTree(pc_down).query_ball_point(keypoints, search_radius)
    return [np.zeros([1024, 3], dtype=np.float32) if len(indices) <= 1
            else pc_down[indices].astype(np.float32) for indices in results]


def _read_pose(scene_dir: str, idx: int) -> np.ndarray:
    p1 = os.path.join(scene_dir, f'cloud_bin_{idx}.pose.npy')
    p2 = os.path.join(scene_dir, f'cloud_bin_{idx}_pose.txt')
    if os.path.exists(p1):
        return np.load(p1)
    return np.loadtxt(p2)


class PointCloudPairSampler:
    """Index stream reshuffled every epoch from a seeded RandomState."""

    def __init__(self, datasize: int, seed: int = 0):
        self.datasize = datasize
        self.rng = np.random.RandomState(seed)
        self.indices = self._gen()
        self.regen_flag = False

    def _gen(self):
        idx = np.arange(self.datasize)
        self.rng.shuffle(idx)
        return list(idx)

    def __iter__(self):
        if self.regen_flag:
            self.indices = self._gen()
        else:
            self.regen_flag = True
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class FragmentLoader:
    """Keypoint pairs of fused fragments: each item is npt patch pairs
    ('src', 'tgt' [npt, input_num, 3]) around keypoints drawn from one pair
    file, the fragments, the relative rotation T and an id. Without
    augmentation only (the 3DMatch entry point forces it)."""

    def __init__(self, opt, search_radius, npt=24, kptname='kpts',
                 use_normals=False):
        if use_normals:
            raise NotImplementedError('normals input is not ported')
        if not opt.no_augmentation:
            raise NotImplementedError('3DMatch training augmentation is not '
                                      'ported (the entry point forces '
                                      '--no-augmentation)')
        self.opt = opt
        self.data_path = os.path.join(opt.dataset_path, 'fused_fragments')
        self.keypoint_path = os.path.join(opt.dataset_path, kptname)
        self.search_radius = search_radius
        self.input_num = opt.model.input_num
        self.voxel_size = 0.03 if self.input_num < 1024 else 0.015
        self.npt = npt
        self.rng = np.random.RandomState(opt.seed)

        def frag_path(scene, seq, idx):
            return os.path.join(self.data_path, scene, seq,
                                f'cloud_bin_{idx}.ply')

        self.kptfiles = []
        for scene in sorted(os.listdir(self.keypoint_path)):
            seq_paths = [sq for sq in glob.glob(
                os.path.join(self.keypoint_path, scene, 'seq*'))
                if os.path.isdir(sq)]
            if len(seq_paths) == 0:
                seq_paths = [os.path.join(self.keypoint_path, scene)]
            for seq_path in seq_paths:
                seq = (os.path.basename(seq_path)
                       if seq_path.endswith(tuple(f'seq-{i:02d}'
                                                  for i in range(100)))
                       or 'seq' in os.path.basename(seq_path) else '')
                if seq_path == os.path.join(self.keypoint_path, scene):
                    seq = ''
                for kptf in sorted(glob.glob(os.path.join(seq_path,
                                                          '*.npy'))):
                    pair = _parse_pair_name(os.path.basename(kptf))
                    if pair is None:
                        continue
                    idx1, idx2 = pair
                    scene_dir = os.path.join(self.data_path, scene, seq)
                    self.kptfiles.append(Kptmeta(
                        np.load(kptf), f'{scene}_{seq}_{idx1}_{idx2}',
                        frag_path(scene, seq, idx1),
                        frag_path(scene, seq, idx2),
                        _read_pose(scene_dir, idx1),
                        _read_pose(scene_dir, idx2)))

    def __len__(self):
        return len(self.kptfiles)

    def __getitem__(self, index):
        meta = self.kptfiles[index]
        choice = self.rng.choice(np.arange(meta.indices.shape[0]), self.npt)
        kpts = meta.indices[choice].astype(np.int32)
        pcdA = load_ply(meta.pathA)
        pcdB = load_ply(meta.pathB)
        rawA = radius_ball_search(pcdA, kpts[:, 0], self.search_radius,
                                  self.voxel_size)
        rawB = radius_ball_search(pcdB, kpts[:, 1], self.search_radius,
                                  self.voxel_size)
        # T = R_poseA^T R_poseB (the poses are row-major rigid matrices)
        T = np.asarray(meta.poseA)[:3, :3].T @ np.asarray(meta.poseB)[:3, :3]
        inputA = np.array([self._preprocess(p) for p in rawA])
        inputB = np.array([self._preprocess(p) for p in rawB])
        return {'src': inputA.astype(np.float32),
                'tgt': inputB.astype(np.float32),
                'frag_src': pcdA, 'frag_tgt': pcdB,
                'T': T.astype(np.float32), 'fn': meta.id}

    def _preprocess(self, pc):
        _, pc = pctk.uniform_resample_np(pc, self.input_num, rng=self.rng)
        return pc
