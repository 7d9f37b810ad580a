"""Synthetic data (copy of the ModelNet and 3DMatch parts of
``epn_pointcloud_tpu/data/synthetic.py``): a ModelNet40-like .mat tree,
<root>/<cat>/<split>/*.mat with 'pc', 'label', 'name' (its airplanes
asymmetric for the alignment loader, on request), and a 3DMatch-like
fragment tree; each writes the same files as the JAX package's generator
for the same arguments.
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


def make_asym_shape(rng: np.random.RandomState, n_points: int) -> np.ndarray:
    """A shape with no rotational self-symmetry: three unequal,
    non-collinear clusters and an off-axis bar, so the relative rotation of
    an alignment pair is well posed."""
    centers = np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [0.0, 1.0, 0.3]])
    scales = np.array([0.15, 0.3, 0.08])
    n_bar = n_points // 4
    n_cl = n_points - n_bar
    which = rng.randint(0, 3, n_cl)
    pc_cl = centers[which] + scales[which, None] * rng.randn(n_cl, 3)
    t = rng.rand(n_bar)
    bar = (np.array([0.2, -0.8, 0.9])[None] * t[:, None]
           + np.array([0.5, 0.2, -0.4])[None]
           + 0.03 * rng.randn(n_bar, 3))
    pc = np.concatenate([pc_cl, bar], 0)
    return pc.astype(np.float32)


def make_modelnet_tree(root: str, n_cats: int = 4, n_train: int = 8,
                       n_test: int = 4, n_points: int = 2048,
                       seed: int = 0, splits=('train', 'test', 'testR'),
                       airplane_asym: bool = False):
    """Create a synthetic ModelNet-like .mat tree (same files, for the same
    arguments, as the JAX package's generator with its default shapes).
    Category 0 is named 'airplane'; with ``airplane_asym`` its clouds are
    ``make_asym_shape``'s, for the alignment loader."""
    rng = np.random.RandomState(seed)
    names = ['airplane'] + [f'cat{i:02d}' for i in range(1, n_cats)]
    for ci, cat in enumerate(names):
        for split in splits:
            n = n_train if split == 'train' else n_test
            d = os.path.join(root, cat, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                pc = (make_asym_shape(rng, n_points)
                      if ci == 0 and airplane_asym
                      else make_shape(rng, n_points, ci))
                data = {'pc': pc, 'label': np.array([[ci]]),
                        'name': f'{cat}_{split}_{i:04d}'}
                sio.savemat(os.path.join(d, f'{cat}_{i:04d}.mat'), data)
    return root


def make_3dmatch_tree(root: str, scene: str = 'synth-scene', n_frags: int = 3,
                      n_points: int = 4000, n_kpts: int = 32, seed: int = 0,
                      extent=(3.0, 3.0, 2.0), kpt_margin: float = 0.0):
    """Synthetic 3DMatch-style data with the real data's on-disk contracts:

    eval:  <root>/<scene>/cloud_bin_N.ply,
           01_Keypoints/cloud_bin_NKeypoints.txt, gt.log
    train: <root>/fused_fragments/<scene>/seq-01/cloud_bin_N.ply (+pose) and
           <root>/kpts/<scene>/seq-01/cloud_bin_A-cloud_bin_B.npy

    Fragments are overlapping views of one 'room' cloud under rigid motions.
    ``extent`` sets the point density: a patch needs >= input_num distinct
    points in its search ball, or the InstanceNorm backbone amplifies fp32
    noise on the duplicate-padded patch; ``kpt_margin`` keeps keypoints that
    far from the room's walls, so their balls are whole.
    """
    from ..ops.ply import save_ply
    from ..ops.rotation import rand_rotation_matrix
    rng = np.random.RandomState(seed)
    room = rng.rand(n_points * 2, 3) * np.asarray(extent, np.float64)
    scene_dir = os.path.join(root, scene)
    kp_dir = os.path.join(scene_dir, '01_Keypoints')
    os.makedirs(kp_dir, exist_ok=True)
    frag_dir = os.path.join(root, 'fused_fragments', scene, 'seq-01')
    kpt_dir = os.path.join(root, 'kpts', scene, 'seq-01')
    os.makedirs(frag_dir, exist_ok=True)
    os.makedirs(kpt_dir, exist_ok=True)

    # every fragment sees a common core (the cross-fragment keypoint
    # correspondences) plus its own random extras
    core = rng.choice(len(room), n_points // 2, replace=False)
    kpt_pool = core
    if kpt_margin > 0:
        lo = np.asarray([kpt_margin] * 3)
        hi = np.asarray(extent, np.float64) - kpt_margin
        interior = np.all((room[core] > lo) & (room[core] < hi), axis=1)
        assert interior.sum() >= n_kpts, (
            f'only {interior.sum()} interior core points for {n_kpts} '
            f'keypoints: grow extent or shrink kpt_margin')
        kpt_pool = core[interior]
    kpt_world = rng.choice(kpt_pool, n_kpts, replace=False)

    frags, poses = [], []
    for i in range(n_frags):
        extras = rng.choice(np.setdiff1d(np.arange(len(room)), core),
                            n_points - len(core), replace=False)
        sel = np.concatenate([core, extras])
        rng.shuffle(sel)
        frag_world = room[sel] + 0.001 * rng.randn(n_points, 3)
        R = rand_rotation_matrix(rng=rng)
        t = rng.randn(3) * 0.1
        # camera frame: x_cam = R (x_world - t); pose maps cam -> world
        frag_cam = (frag_world - t) @ R.T
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, 3] = t
        frags.append((frag_cam.astype(np.float32), sel))
        poses.append(pose)

        save_ply(os.path.join(scene_dir, f'cloud_bin_{i}.ply'), frag_cam)
        save_ply(os.path.join(frag_dir, f'cloud_bin_{i}.ply'), frag_cam)
        np.save(os.path.join(frag_dir, f'cloud_bin_{i}.pose.npy'), pose)
        # keypoints: the same world points in every fragment
        kpts = np.array([int(np.where(sel == w)[0][0]) for w in kpt_world])
        np.savetxt(os.path.join(kp_dir, f'cloud_bin_{i}Keypoints.txt'),
                   kpts, fmt='%d')

    # gt.log and the training keypoint pairs of consecutive fragments
    lines = []
    for i in range(n_frags - 1):
        j = i + 1
        # the transform mapping frag_j camera coordinates into frag_i's
        T = np.linalg.inv(poses[i]) @ poses[j]
        lines.append(f'{i}\t{j}\t{n_frags}')
        for r in range(4):
            lines.append('\t'.join(f'{v:.8f}' for v in T[r]))
        # correspondence pairs: the same room point seen in both fragments
        sel_i, sel_j = frags[i][1], frags[j][1]
        common, ii, jj = np.intersect1d(sel_i, sel_j, return_indices=True)
        take = rng.choice(len(common), min(200, len(common)), replace=False)
        pairs = np.stack([ii[take], jj[take]], axis=1).astype(np.int64)
        np.save(os.path.join(kpt_dir, f'cloud_bin_{i}-cloud_bin_{j}.npy'),
                pairs)
    with open(os.path.join(scene_dir, 'gt.log'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return scene_dir
