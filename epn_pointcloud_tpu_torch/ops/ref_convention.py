"""Reference-exact anchor convention (compat mode): the port's own copy of
``epn_pointcloud_tpu/ops/ref_convention.py`` (numpy only), reading the
port's own copy of the vendored geometry,
``epn_pointcloud_tpu_torch/data_assets/ref_geometry.npz`` (byte for byte
the JAX package's).

The native convention in `ops/icosahedron.py` builds the 60-element
icosahedral group by generator closure, with the identity anchor at index 0.
The reference instead derives per-face Euler rotations from the face normals
of `sphere12.ply` (trimesh load order) and normalizes so index 29 is the
identity (ref: vgtk/vgtk/functional/rotation.py:236-344). The two sets are
identical AS SETS, but the *ordering* and the 60x12 intra adjacency differ —
so reference-trained weights cannot be imported under the native convention.

This module reproduces the reference ordering exactly so that
``icosahedron.set_convention('reference')`` makes anchors/trace_idx/identity
index match `vgtk.so3conv.get_anchors()` / `get_intra_idx()` bit-for-bit
(validated by tests/test_reference_parity.py against the real reference run
with the same mesh, and this copy by tests/test_torch_port_ref_convention.py
against the JAX package's). The mesh is the vendored copy of the
reference's `sphere12.ply` (data_assets/ref_geometry.npz); trimesh itself is
replaced by two small facts about its behavior on this watertight convex
mesh:

  * ``mesh.face_normals`` after ``fix_normals()``: the shipped winding is
    already consistent + outward (verified: every stored face normal has
    positive dot with its centroid), so normals are the plain per-face cross
    products in file order.
  * ``mesh.face_adjacency``: rows are (face, face) pairs sharing an edge, in
    lexicographic order of the sorted edge (trimesh groups
    ``edges_sorted`` by hash; only the ROW order is consumed downstream —
    ``get_adjmatrix_trimesh`` scans ``np.argwhere(face_adj == i)`` row-major,
    ref: rotation.py:117-127).

Everything below is import-time numpy, cached at module level.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, 'data_assets',
                       'ref_geometry.npz')

GAMMA_SIZE = 3  # ref: so3conv/functional.py:274


@functools.lru_cache(maxsize=1)
def _assets():
    return np.load(os.path.abspath(_ASSETS))


def ref_mesh():
    """(verts [12,3] f64, faces [20,3] int) — the reference's sphere12.ply."""
    d = _assets()
    return d['sphere12_verts'].astype(np.float64), d['sphere12_faces']


def ref_kernel_points(n_points: int) -> np.ndarray:
    """Raw kpsphere{24,30,66}.ply coordinates, float32 [n,3] (unscaled)."""
    return _assets()[f'kpsphere{n_points}'].astype(np.float32)


def ref_sphere_points(n: int) -> np.ndarray:
    """sphere{12,42,92,162}.ply vertex directions (legacy ZPConv anchors)."""
    if n == 12:
        return _assets()['sphere12_verts'].astype(np.float32)
    return _assets()[f'sphere{n}'].astype(np.float32)


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-face unit normals in file order (= trimesh.face_normals here: the
    shipped winding is consistent-outward, so fix_normals() is a no-op)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # the premise the derivation rests on — fail loudly if the asset changes
    cent = (v0 + v1 + v2) / 3.0
    assert ((nrm * cent).sum(1) > 0).all(), 'sphere12 winding not outward'
    return nrm


def _face_adjacency_pairs(faces: np.ndarray) -> np.ndarray:
    """[n_edges, 2] face-index pairs sharing an edge, rows in lexicographic
    order of the sorted edge (trimesh.graph.face_adjacency row semantics)."""
    pairs = {}
    for fi, f in enumerate(faces):
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            pairs.setdefault((min(a, b), max(a, b)), []).append(fi)
    rows = []
    for edge in sorted(pairs):
        fs = pairs[edge]
        assert len(fs) == 2, 'mesh not watertight'
        rows.append(fs)
    return np.asarray(rows, dtype=np.int64)


def _adjmatrix(faces: np.ndarray, gsize: int) -> np.ndarray:
    """[na*gsize, 4*gsize] anchor adjacency (ref: get_adjmatrix_trimesh,
    rotation.py:117-139): per face, its 3 edge-neighbors in face_adjacency
    row order, expanded over gammas gamma-major ([f0g0 f1g0 f2g0 f0g1 ...]),
    then the face's own gsize gammas appended."""
    na = len(faces)
    adj_pairs = _face_adjacency_pairs(faces)
    neighbors = np.empty((na, 3), dtype=np.int64)
    for i in range(na):
        where = np.argwhere(adj_pairs == i)            # row-major scan order
        neighbors[i] = adj_pairs[where[:, 0], 1 - where[:, 1]]

    g = np.arange(gsize)
    # columns g*3+j hold neighbor face j at gamma g  (ref: :134-135)
    nbr = (neighbors[:, None, :] * gsize + g[None, :, None]).reshape(na, -1)
    own = np.arange(na)[:, None] * gsize + g[None, :]  # ref: :136-137
    full = np.concatenate([nbr, own], axis=1)          # [na, 4*gsize]
    return np.repeat(full, gsize, axis=0)              # [na*gsize, 4*gsize]


def _so3_from_normals(normals: np.ndarray, gsize: int) -> np.ndarray:
    """60 rotations from the 20 face normals x gsize in-plane gammas
    (ref: get_so3_from_anchors_np, rotation.py:141-219). Each anchor is the
    Euler product R = Rx(gamma) @ Ry(beta) @ Rz(alpha) where (alpha, beta)
    point the x-axis image at the face normal; faces in the two middle/outer
    z-bands whose stored constants are -0.19/+0.79 get a fixed +60 deg gamma
    phase (the reference's closure fix, rotation.py:215-218)."""
    na = normals.shape[0]
    sbeta = normals[:, 2]
    cbeta = np.sqrt(1.0 - sbeta ** 2)
    calpha = normals[:, 0] / cbeta
    salpha = normals[:, 1] / cbeta

    gammas = -np.linspace(0, 2 * np.pi, gsize, endpoint=False,
                          dtype=np.float32).astype(np.float64)
    phase = np.deg2rad(60.0)  # `padding` in the reference

    zeros, ones = np.zeros(na), np.ones(na)
    Rz = np.stack([calpha, salpha, zeros,
                   -salpha, calpha, zeros,
                   zeros, zeros, ones], axis=1).reshape(na, 3, 3)
    Ry = np.stack([cbeta, zeros, sbeta,
                   zeros, ones, zeros,
                   -sbeta, zeros, cbeta], axis=1).reshape(na, 3, 3)

    def rx(g):
        c, s = np.cos(g), np.sin(g)
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])

    # z-band selector: which faces use the +60deg-phased gamma set
    use_phase = (np.abs(sbeta + 0.19) < 0.01) | (np.abs(sbeta - 0.79) < 0.01)

    Rs = np.empty((na, gsize, 3, 3))
    for fi in range(na):
        for gi in range(gsize):
            g = gammas[gi] + (phase if use_phase[fi] else 0.0)
            Rs[fi, gi] = rx(g) @ Ry[fi] @ Rz[fi]
    return Rs.reshape(na * gsize, 3, 3)


@functools.lru_cache(maxsize=1)
def build():
    """Reference-convention anchors + intra adjacency.

    Returns dict(anchors [60,3,3] f32, trace_idx [60,12] i32,
    identity_idx=29). The trace_idx derivation follows
    rotation.py:259-344: take the identity-normalized anchors, form the 12
    relative rotations of anchor 0's adjacency stencil, order every anchor's
    neighborhood by nearest-rotation matching, then permute rows by the
    reverse-anchor index map.
    """
    verts, faces = ref_mesh()
    normals = _face_normals(verts, faces)
    Rs = _so3_from_normals(normals, GAMMA_SIZE)

    # normalize so anchor 29 is the identity (ref: rotation.py:257)
    Rs = np.einsum('bij,kj->bik', Rs, Rs[29])

    R_adj = _adjmatrix(faces, GAMMA_SIZE)              # [60, 12]
    grouped = Rs[R_adj]                                # [60, 12, 3, 3]

    # 12 relative rotations of anchor 0's neighborhood (rotation.py:275)
    relative = np.einsum('kjh,lh->kjl', grouped[0], Rs[0])   # [12, 3, 3]
    # ordered_R[b,k] = (relative[k] @ Rs[b])^T  (rotation.py:277)
    ordered = np.einsum('kmj,bji->bkim', relative, Rs)       # [60, 12, 3, 3]

    # nearest-anchor match of each ordered_R by rotation trace (:289-302):
    # tr(ordered[b,k] @ Rs[c]^T) = sum_ij ordered[b,k,i,j] * Rs[c,i,j]
    diff_tr = np.einsum('bkij,cij->bkc', ordered, Rs)
    trace_idx = np.argmax(0.5 * (diff_tr - 1.0), axis=2)     # [60, 12]

    # row permutation by the reverse index map (rotation.py:306-307)
    rev = np.argmax(
        np.einsum('nij,mjk->nmji', Rs, Rs).sum(axis=(2, 3)), axis=1)
    trace_idx = trace_idx[rev]

    anchors = Rs.astype(np.float32)
    assert np.allclose(anchors[29], np.eye(3), atol=1e-6)
    # each row must be a permutation-free index set into distinct anchors
    assert all(len(set(row)) == GAMMA_SIZE * 4 for row in trace_idx.tolist())
    return {
        'anchors': anchors,
        'trace_idx': trace_idx.astype(np.int32),
        'identity_idx': 29,
    }
