"""3DMatch feature-match recall (counterpart of
``epn_pointcloud_tpu/eval/evaluation_3dmatch.py``): mutual nearest-neighbor
matching of the keypoint descriptors of each ground-truth fragment pair; a
match is an inlier if its keypoints lie within tau1 = 0.1 m of each other
under the ground-truth transform; a pair is recalled if its inlier ratio
exceeds tau2; the recall is reported at tau2 in TAU_RANGE. Host work only
(numpy and scipy's KD-tree), in a spawn pool of workers or serially."""

from __future__ import annotations

import os
from os.path import join

import numpy as np
from scipy.spatial import cKDTree

from ..data.match_3dmatch import worker_pool
from ..ops.ply import load_ply

TAU_RANGE = [0.05, 0.1, 0.2]


def read_key_point(path):
    with open(path, 'r') as fin:
        return np.array([int(i) for i in fin.readlines() if i.strip()])


def read_feature(path, descriptor_name='ours'):
    if descriptor_name in ('ours', 'lmvd'):
        return np.load(path)
    if descriptor_name == '3DSmooth':
        return np.load(path)['data']
    raise ValueError('No such descriptor')


def read_gt_log(path):
    """gt.log: 5 lines a pair (the two fragment ids, then the 4 x 4
    transform) -> (pairs [n, 2], transforms [n, 4, 4])."""
    fragment_pairs, gt_transforms = [], []
    with open(path, 'r') as fin:
        lines = fin.readlines()
    for i in range(len(lines) // 5):
        data = lines[i * 5].split()
        fragment_pairs.append([int(data[0]), int(data[1])])
        gt_transforms.append([list(map(float, lines[i * 5 + j + 1].split()))
                              for j in range(4)])
    return np.array(fragment_pairs), np.array(gt_transforms)


def hom_transform(points, T, translation=True):
    if translation:
        points = np.hstack((points, np.ones((points.shape[0], 1))))
        return (points @ T.T)[:, :3]
    return points[:, :3] @ T[:3, :3].T


def evaluate_fragment_pair(src_frag_id, tgt_frag_id, src_pc_path, tgt_pc_path,
                           src_kp_path, tgt_kp_path, src_feat_path,
                           tgt_feat_path, gt_transform, tau1=0.1,
                           descriptor='ours'):
    """(n_inlier, inlier_ratio, [src id, tgt id, n_inlier, ratio], the
    matched keypoint index pairs within tau1) of one fragment pair."""
    src_point_cloud = load_ply(src_pc_path)
    tgt_point_cloud = load_ply(tgt_pc_path)
    src_key_point_ids = read_key_point(src_kp_path)
    tgt_key_point_ids = read_key_point(tgt_kp_path)
    src_feats = read_feature(src_feat_path, descriptor)
    tgt_feats = read_feature(tgt_feat_path, descriptor)
    assert src_feats.ndim == 2

    src_key_point_locs = src_point_cloud[src_key_point_ids]
    tgt_key_point_locs = tgt_point_cloud[tgt_key_point_ids]

    src_KDT = cKDTree(src_feats)
    tgt_KDT = cKDTree(tgt_feats)
    _, src_tgt_nn_ids = tgt_KDT.query(src_feats, k=1)
    _, tgt_src_nn_ids = src_KDT.query(tgt_feats, k=1)

    mutual_closest_ids = (np.arange(src_tgt_nn_ids.shape[0])
                          == src_tgt_nn_ids[tgt_src_nn_ids])
    src_match_point_locs = src_key_point_locs[
        tgt_src_nn_ids[mutual_closest_ids]]
    tgt_match_point_locs = tgt_key_point_locs[mutual_closest_ids]
    tgt_match_point_locs = hom_transform(tgt_match_point_locs, gt_transform)

    distances = np.sqrt(np.sum(
        (src_match_point_locs - tgt_match_point_locs) ** 2, 1))
    n_inlier = int((distances < tau1).sum())
    inlier_ratio = float(n_inlier) / distances.shape[0]

    # the matched keypoint pairs within tau1 (the lmvd test keypoints)
    mid_tgt = np.argwhere(mutual_closest_ids)
    mid_src = tgt_src_nn_ids[mutual_closest_ids][:, None]
    select = distances < tau1
    kpts = np.concatenate((src_key_point_ids[mid_src[select]],
                           tgt_key_point_ids[mid_tgt[select]]), 1)

    result_log = [src_frag_id, tgt_frag_id, n_inlier, inlier_ratio]
    return n_inlier, inlier_ratio, result_log, kpts


def evaluate_scene(scene_dir, feature_dir, scene_name, suffix=None,
                   num_thread=8, tau2=0.05):
    """The recall [(tau, percent)] of one scene over its gt.log pairs whose
    feature files exist under feature_dir; writes feature_dir/recall.txt
    (a row a pair: ids, inliers, inlier ratio)."""
    scene_dir = join(scene_dir, scene_name)

    if 'seq-01' in os.listdir(scene_dir):
        def get_pc_path(x):
            return join(scene_dir, 'seq-01', f'cloud_bin_{x}.ply')

        def get_kp_path(x):
            return join(scene_dir, 'seq-01', f'cloud_bin_{x}.keypts.txt')
        gt_path = join(scene_dir, 'seq-01', 'gt.log')
    else:
        def get_pc_path(x):
            return join(scene_dir, f'cloud_bin_{x}.ply')

        def get_kp_path(x):
            return join(scene_dir, '01_Keypoints',
                        f'cloud_bin_{x}Keypoints.txt')
        gt_path = join(scene_dir, 'gt.log')

    if suffix is None:
        descriptor = 'ours'

        def get_feat_path(x):
            return join(feature_dir, f'feature{x}.npy')
    elif suffix == 'lmvd':
        descriptor = 'lmvd'

        def get_feat_path(x):
            return join(feature_dir, f'cloud_bin_{x}.desc.npy')
    else:
        descriptor = '3DSmooth'

        def get_feat_path(x):
            return join(feature_dir, f'_cloud_bin_{x}.ply_{suffix}.npz')

    fragment_pairs, gt_transforms = read_gt_log(gt_path)

    mp_args = []
    for fragment_pair, gt_transform in zip(fragment_pairs, gt_transforms):
        src_frag_id, tgt_frag_id = int(fragment_pair[0]), int(fragment_pair[1])
        srcp, tgtp = get_feat_path(src_frag_id), get_feat_path(tgt_frag_id)
        if not os.path.exists(srcp) or not os.path.exists(tgtp):
            print(f'Path at {srcp} does not exist!!')
            continue
        mp_args.append([src_frag_id, tgt_frag_id,
                        get_pc_path(src_frag_id), get_pc_path(tgt_frag_id),
                        get_kp_path(src_frag_id), get_kp_path(tgt_frag_id),
                        srcp, tgtp, gt_transform, 0.1, descriptor])

    pool = worker_pool(min(num_thread, len(mp_args)))
    if pool is None:
        rst = [evaluate_fragment_pair(*a) for a in mp_args]
    else:
        with pool:
            rst = pool.starmap(evaluate_fragment_pair, mp_args)
    n_inliers, inlier_ratios, result_log, kpts = zip(*rst)

    if suffix == 'lmvd':
        output_folder = join(scene_dir, 'lmvd_test_kpts')
        os.makedirs(output_folder, exist_ok=True)
        for args, kp in zip(mp_args, kpts):
            np.save(join(output_folder,
                         f'cloud_bin_{args[0]}-cloud_bin_{args[1]}.keypts.npy'),
                    kp)

    inlier_ratios = np.array(inlier_ratios)
    total_recall = np.mean(inlier_ratios > tau2)
    print('Total recall is %0.2f' % (total_recall * 100))
    np.savetxt(join(feature_dir, 'recall.txt'), np.array(result_log),
               fmt='%.2f', delimiter=',')
    return [(tau, 100 * np.mean(inlier_ratios > tau)) for tau in TAU_RANGE]
