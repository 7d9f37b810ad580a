"""3DMatch loaders (counterpart of ``epn_pointcloud_tpu/data/
match_3dmatch.py``: ``radius_ball_search``, ``PointCloudPairSampler``, the
training ``FragmentLoader``, the pairwise ``FragmentTestLoader`` and the
evaluation's ``SceneEvalLoader`` and ``SceneTestLoader``).

On-disk contracts:
  * train: <root>/fused_fragments/<scene>/<seq>/cloud_bin_N.ply (with its
    pose as cloud_bin_N.pose.npy or cloud_bin_N_pose.txt) and
    <root>/<kptname>/<scene>/<seq>/cloud_bin_A-cloud_bin_B.npy keypoint
    index pairs.
  * eval: <root>/<scene>/cloud_bin_N.ply and
    01_Keypoints/cloud_bin_NKeypoints.txt, with the patches cached in
    grouped_data_r<radius %.2f>/grouped_cloud_bin_N.npz.

Fragments are voxel-downsampled (``data/pc.voxel_downsample_np``) and
searched with scipy's KDTree: the JAX package's numpy / scipy path. Its
compiled host ops (``epn_pointcloud_tpu/native``), which it takes when they
load, give other voxel arrays and radius lists, so the port follows the
fallback.
"""

from __future__ import annotations

import glob
import multiprocessing
import os
import re
import sys
from collections import namedtuple

import numpy as np
from scipy.spatial import KDTree

from ..ops.ply import load_ply
from . import pc as pctk

Kptmeta = namedtuple('Kptmeta', 'indices, id, pathA, pathB, poseA, poseB')


def parse_scene_id(path: str) -> int:
    """'.../cloud_bin_N...' -> N, else -1."""
    m = re.search(r'cloud_bin_(\d+)', os.path.basename(path))
    return int(m.group(1)) if m else -1


def _parse_pair_name(name: str, suffix: str = '.npy'):
    """'cloud_bin_A-cloud_bin_B<suffix>' -> (A, B), else None."""
    m = re.match(r'cloud_bin_(\d+)-cloud_bin_(\d+)' + re.escape(suffix), name)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def radius_ball_search(points: np.ndarray, kpt_indices: np.ndarray,
                       search_radius: float, voxel_size: float = 0.015,
                       input_num=None, rng=None):
    """The points of the voxel-downsampled cloud within search_radius of
    each keypoint, a patch a keypoint, resampled to ``input_num`` points
    (from ``rng``) when it is given; a keypoint with at most one point in
    its ball gets a zero patch (of input_num points, else 1024). Returns
    (patches, the downsampled cloud)."""
    rng = rng or np.random
    keypoints = points[kpt_indices]
    pc_down = pctk.voxel_downsample_np(points, voxel_size)
    results = KDTree(pc_down).query_ball_point(keypoints, search_radius)
    all_pc = []
    for indices in results:
        if len(indices) <= 1:
            n = 1024 if input_num is None else input_num
            all_pc.append(np.zeros([n, 3], dtype=np.float32))
        else:
            patch = pc_down[indices]
            if input_num is not None:
                _, patch = pctk.uniform_resample_np(patch, input_num, rng=rng)
            all_pc.append(patch.astype(np.float32))
    return all_pc, pc_down


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
    augmentation only (the 3DMatch entry point forces it). ``use_normals``
    is stored and read nowhere, as the JAX loader stores it: the patches
    stay 3-channel."""

    def __init__(self, opt, search_radius, npt=24, kptname='kpts',
                 use_normals=False):
        self.use_normals = use_normals
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
        rawA, _ = radius_ball_search(pcdA, kpts[:, 0], self.search_radius,
                                     self.voxel_size, rng=self.rng)
        rawB, _ = radius_ball_search(pcdB, kpts[:, 1], self.search_radius,
                                     self.voxel_size, rng=self.rng)
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


class FragmentTestLoader:
    """Pairwise test loader over <root>/<scene>/lmvd_test_kpts/
    cloud_bin_A-cloud_bin_B.keypts.npy: a pair file of more than 2 * npt
    keypoint pairs is split in two, every tenth split is kept, and an item
    is the patches of its first npt pairs ('src', 'tgt' [npt, input_num,
    3]), the fragments and an id. ``use_normals`` is stored and read
    nowhere, as in the JAX loader."""

    def __init__(self, opt, test_path, search_radius, use_normals=False,
                 npt=24):
        self.use_normals = use_normals
        self.opt = opt
        self.data_path = test_path
        self.search_radius = search_radius
        self.input_num = opt.model.input_num
        self.voxel_size = 0.03 if self.input_num < 1024 else 0.015
        self.npt = npt
        self.rng = np.random.RandomState(opt.seed)

        n_split = 2
        self.kptfiles = []
        for scene in sorted(os.listdir(self.data_path)):
            kpt_dir = os.path.join(self.data_path, scene, 'lmvd_test_kpts')
            if not os.path.isdir(kpt_dir):
                continue
            for kptf in sorted(glob.glob(os.path.join(kpt_dir,
                                                      '*.keypts.npy'))):
                pair = _parse_pair_name(os.path.basename(kptf), '.keypts.npy')
                if pair is None:
                    continue
                idx1, idx2 = pair
                kpts = np.load(kptf)
                if kpts.shape[0] > n_split * npt:
                    for arr in np.array_split(kpts, n_split, 0):
                        self.kptfiles.append(Kptmeta(
                            arr, f'{scene}AT{idx1}_{idx2}',
                            os.path.join(self.data_path, scene,
                                         f'cloud_bin_{idx1}.ply'),
                            os.path.join(self.data_path, scene,
                                         f'cloud_bin_{idx2}.ply'),
                            None, None))
        self.kptfiles = self.kptfiles[::10]

    def __len__(self):
        return len(self.kptfiles)

    def __getitem__(self, index):
        meta = self.kptfiles[index]
        kpts = meta.indices[:self.npt].astype(np.int32)
        pcdA = load_ply(meta.pathA)
        pcdB = load_ply(meta.pathB)
        rawA, _ = radius_ball_search(pcdA, kpts[:, 0], self.search_radius,
                                     self.voxel_size, rng=self.rng)
        rawB, _ = radius_ball_search(pcdB, kpts[:, 1], self.search_radius,
                                     self.voxel_size, rng=self.rng)
        inputA = np.array([self._preprocess(p) for p in rawA])
        inputB = np.array([self._preprocess(p) for p in rawB])
        return {'src': inputA.astype(np.float32),
                'tgt': inputB.astype(np.float32),
                'frag_src': pcdA, 'frag_tgt': pcdB, 'id': meta.id}

    def _preprocess(self, pc):
        _, pc = pctk.uniform_resample_np(pc, self.input_num, rng=self.rng)
        return pc


class SceneEvalLoader:
    """The keypoint patches of one scene's fragments for the descriptor
    evaluation: item N is fragment N's patches ('clouds' [n_kpts,
    input_num, 3]), the fragment and its id. The patches are read from the
    scene's npz cache when it holds them (resampled if they have another
    size), else searched, resampled from a RandomState(seed) and cached.
    ``--normals`` is stored (``use_normals``) and read nowhere, as in the
    JAX loader."""

    def __init__(self, opt, scene):
        self.use_normals = opt.model.normals
        self.opt = opt
        self.data_path = os.path.join(opt.dataset_path, scene)
        self.search_radius = opt.model.search_radius
        self.input_num = opt.model.input_num
        self.voxel_size = 0.03 if self.input_num < 1024 else 0.015
        self.rng = np.random.RandomState(opt.seed)
        self.kptsfiles = glob.glob(os.path.join(
            self.data_path, '01_Keypoints', 'cloud_bin_*Keypoints.txt'))

    def readkptf(self, idx):
        return np.loadtxt(os.path.join(
            self.data_path, '01_Keypoints',
            f'cloud_bin_{idx}Keypoints.txt')).astype(np.int32)

    def grouped_path(self, idx):
        return os.path.join(self.data_path,
                            'grouped_data_r%.2f' % self.search_radius,
                            f'grouped_cloud_bin_{idx}.npz')

    def __len__(self):
        return len(self.kptsfiles)

    def __getitem__(self, index):
        frag = load_ply(os.path.join(self.data_path,
                                     f'cloud_bin_{index}.ply'))
        gpath = self.grouped_path(index)
        if os.path.exists(gpath):
            clouds = np.load(gpath)['arr_0'].astype(np.float32)
            if clouds.shape[1] != self.input_num:
                clouds = np.array([self._process(pc) for pc in clouds],
                                  dtype=np.float32)
        else:
            raw_clouds, _ = radius_ball_search(frag, self.readkptf(index),
                                               self.search_radius,
                                               self.voxel_size, rng=self.rng)
            clouds = np.array([self._process(pc) for pc in raw_clouds],
                              dtype=np.float32)
            os.makedirs(os.path.dirname(gpath), exist_ok=True)
            np.savez(gpath, clouds)
        return {'clouds': clouds, 'frag': frag, 'sid': index}

    def _process(self, pc):
        if pc.shape[0] != self.input_num:
            _, pc = pctk.uniform_resample_np(pc, self.input_num, rng=self.rng)
        return pc


def worker_pool(n: int):
    """A pool of n host workers started by spawn (a CUDA context does not
    survive fork), or None where spawn cannot re-import the main module (a
    caller with no script file): the caller then runs serially."""
    main_file = getattr(sys.modules.get('__main__'), '__file__', None)
    if n <= 1 or main_file is None or not os.path.exists(main_file):
        return None
    return multiprocessing.get_context('spawn').Pool(n)


class SceneTestLoader:
    """Streaming per-scene patch batcher: ``prepare(scene)``, then
    ``next_batch()`` fills ``batch_data`` with the next batch_size patches
    of the current fragment, from the npz caches (``grouped``) or searched
    from the keypoints; ``precompute_patches`` writes the caches."""

    def __init__(self, opt, grouped=False, datafilter=None):
        self.opt = opt
        self.data_path_root = opt.dataset_path
        self.batch_size = opt.batch_size
        self.search_radius = opt.model.search_radius
        self.knn = opt.model.input_num
        self.grouped = grouped
        self.datafilter = datafilter
        self.rng = np.random.RandomState(opt.seed)

    def prepare(self, scene):
        self.data_path = os.path.join(self.data_path_root, scene)
        self.current_scene = scene
        if self.grouped:
            self.datafiles = glob.glob(os.path.join(
                self.data_path, 'grouped_data_r%.2f' % self.search_radius,
                '*.npz'))
            if len(self.datafiles) == 0:
                raise ValueError(f'Test data patches do not exist: '
                                 f'{self.data_path}')
            if self.datafilter is not None:
                self.datafiles = list(filter(self.datafilter, self.datafiles))
            self.datafiles.sort(key=parse_scene_id)
            self.datasize = len(self.datafiles)
        else:
            self.kptsfiles = glob.glob(
                os.path.join(self.data_path, '01_Keypoints') + '/*.txt')
            if self.datafilter is not None:
                self.kptsfiles = list(filter(self.datafilter, self.kptsfiles))
            self.pcfiles = glob.glob(self.data_path + '/*.ply')
            if len(self.kptsfiles) == 0 or len(self.pcfiles) == 0:
                raise ValueError(f'Test data does not exist: {self.data_path}')
            self.pcfiles.sort(key=parse_scene_id)
            self.kptsfiles.sort(key=parse_scene_id)
            self.datasize = len(self.kptsfiles)
        self.batch_pt = 0
        self.scene_pt = -1
        self.reload()

    def reload(self):
        self.scene_pt += 1
        self.batch_pt = 0
        if self.grouped:
            if self.scene_pt < len(self.datafiles):
                self.current_grouped_points = np.load(
                    self.datafiles[self.scene_pt])['arr_0']
                self.current_sid = parse_scene_id(self.datafiles[self.scene_pt])
        elif self.scene_pt < len(self.kptsfiles):
            self.current_kpts = np.loadtxt(self.kptsfiles[self.scene_pt],
                                           dtype=np.int32)
            self.current_sid = parse_scene_id(self.kptsfiles[self.scene_pt])

    def precompute_patches(self, scale=1.0, input_num=1024, num_worker=8):
        """Every fragment's keypoint patches (voxel 0.015, input_num points)
        times ``scale`` into the scene's npz cache; the searches run in a
        spawn pool of num_worker processes, or serially."""
        save_dir = os.path.join(self.data_path,
                                'grouped_data_r%.2f' % self.search_radius)
        os.makedirs(save_dir, exist_ok=True)
        mp_args, sid_list = [], []
        for kptf in self.kptsfiles:
            kpts = np.loadtxt(kptf, dtype=np.int32)
            sid = parse_scene_id(kptf)
            pc = load_ply(self.pcfiles[sid])
            mp_args.append([pc, kpts, self.search_radius, 0.015, input_num])
            sid_list.append(sid)
        pool = worker_pool(min(num_worker, len(mp_args)))
        if pool is None:
            rsts = [radius_ball_search(*a) for a in mp_args]
        else:
            with pool:
                rsts = pool.starmap(radius_ball_search, mp_args)
        for rst, sid in zip(rsts, sid_list):
            np.savez(os.path.join(save_dir, f'grouped_cloud_bin_{sid}.npz'),
                     np.array(rst[0]) * scale)

    def next_batch(self):
        buf = self.current_grouped_points if self.grouped else self.current_kpts
        if self.scene_pt >= self.datasize:
            return False
        kpts = buf[self.batch_pt: self.batch_pt + self.batch_size]
        if self.grouped:
            grouped_points = kpts
            if grouped_points.shape[1] != self.knn:
                grouped_points = np.array([
                    pctk.uniform_resample_np(pc, self.knn, rng=self.rng)[1]
                    for pc in grouped_points])
        else:
            cloud = load_ply(self.pcfiles[self.current_sid])
            patches, _ = radius_ball_search(cloud, kpts, self.search_radius,
                                            0.015, self.knn, rng=self.rng)
            grouped_points = np.array(patches)
        self.batch_data = grouped_points
        self.batch_pt += self.batch_size
        if self.batch_pt >= buf.shape[0]:
            self.reload()
        return True

    @property
    def is_new_scene(self):
        return self.batch_pt == 0

    @property
    def current_scene_length(self):
        buf = self.current_grouped_points if self.grouped else self.current_kpts
        return buf.shape[0]
