"""Icosahedral SO(3) discretization: the 60-element chiral icosahedral group.

Counterpart of ``epn_pointcloud_tpu/ops/icosahedron.py``, with its two
anchor conventions (``set_convention``): 'native', below, and 'reference',
the original EPN's ordering and orientation (identity at 29, from the
vendored ply geometry; ``ops/ref_convention.py``), which a checkpoint
trained by the original EPN needs. Native: the group is built by generator
closure, ordered into (face, gamma) fibers with the identity at index 0,
and the 60x12 intra-convolution adjacency is

  trace_idx[a, k] = index of anchor  R_a @ Q_k

for the fixed 12-element stencil {Q_k} around the identity (9 adjacent-face
gammas, then the 3 same-face gammas). Everything here is numpy, cached at
module level.
"""

from __future__ import annotations

import functools

import numpy as np

GAMMA_SIZE = 3  # in-plane rotations per face


# the anchor convention in force, process-wide: 'native' | 'reference'
_CONVENTION = 'native'
_CONVENTION_LISTENERS: list = []


def register_convention_listener(fn) -> None:
    """Register a zero-argument callback that ``set_convention`` calls on a
    switch (a caller's cache of convention-dependent values flushes
    itself), as in the JAX package. The port's own modules register none:
    they look their constants up per convention at each use
    (``nn.layers.convention_constant``), which replaces the JAX package's
    flushing listeners."""
    _CONVENTION_LISTENERS.append(fn)


def set_convention(name: str) -> None:
    """Switch the global anchor convention ('native' | 'reference')."""
    global _CONVENTION
    if name not in ('native', 'reference'):
        raise ValueError(
            f"convention must be 'native' or 'reference', got {name}")
    if name == _CONVENTION:
        return
    _CONVENTION = name
    for fn in _CONVENTION_LISTENERS:
        fn()


def get_convention() -> str:
    return _CONVENTION


def icosahedron_mesh():
    """Regular icosahedron: 12 unit vertices, 20 outward-oriented faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            verts.append((0.0, a, b))
            verts.append((a, b, 0.0))
            verts.append((b, 0.0, a))
    verts = np.array(verts, dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    d = np.linalg.norm(verts[:, None] - verts[None], axis=-1)
    edge = d[d > 1e-9].min()
    adj = (np.abs(d - edge) < 1e-6)
    faces = []
    n = len(verts)
    for i in range(n):
        for j in range(i + 1, n):
            if not adj[i, j]:
                continue
            for k in range(j + 1, n):
                if adj[i, k] and adj[j, k]:
                    faces.append((i, j, k))
    faces = np.array(sorted(faces), dtype=np.int64)
    assert faces.shape == (20, 3)

    oriented = []
    for f in faces:
        v0, v1, v2 = verts[f]
        nrm = np.cross(v1 - v0, v2 - v0)
        if np.dot(nrm, v0 + v1 + v2) < 0:
            f = f[[0, 2, 1]]
        oriented.append(f)
    return verts, np.array(oriented, dtype=np.int64)


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    nrm = np.cross(v1 - v0, v2 - v0)
    return nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def face_adjacency(faces: np.ndarray) -> np.ndarray:
    """For each face, the 3 faces sharing an edge with it. [20, 3] int."""
    nf = len(faces)
    edge_map: dict[tuple[int, int], list[int]] = {}
    for fi, f in enumerate(faces):
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edge_map.setdefault((min(a, b), max(a, b)), []).append(fi)
    adj = [[] for _ in range(nf)]
    for fs in edge_map.values():
        assert len(fs) == 2
        adj[fs[0]].append(fs[1])
        adj[fs[1]].append(fs[0])
    out = np.array([sorted(a) for a in adj], dtype=np.int64)
    assert out.shape == (nf, 3)
    return out


def _axis_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _generator_closure(gens: list[np.ndarray]) -> np.ndarray:
    """BFS closure of a finite rotation set. Returns deduped [n,3,3]."""
    def key(R):
        return tuple(np.round(R, 9).reshape(-1))

    elems = {key(np.eye(3)): np.eye(3)}
    frontier = [np.eye(3)]
    while frontier:
        nxt = []
        for R in frontier:
            for g in gens:
                P = g @ R
                k = key(P)
                if k not in elems:
                    elems[k] = P
                    nxt.append(P)
        frontier = nxt
        assert len(elems) <= 60
    return np.stack(list(elems.values()))


@functools.lru_cache(maxsize=1)
def _build_group():
    verts, faces = icosahedron_mesh()
    normals = face_normals(verts, faces)
    adj = face_adjacency(faces)

    # closure of a 3-fold face rotation and a 5-fold vertex rotation
    f0 = 0
    g3 = _axis_rotation(normals[f0], 2 * np.pi / 3)
    g5 = _axis_rotation(verts[faces[f0][0]], 2 * np.pi / 5)
    Rs = _generator_closure([g3, g5])
    assert Rs.shape[0] == 60, f'expected 60 elements, got {Rs.shape[0]}'

    # (face, gamma) fibers: fiber(R) = face containing R @ n_f0, ordered by
    # the in-plane angle relative to the fiber member closest to identity
    n0 = normals[f0]
    img = np.einsum('aij,j->ai', Rs, n0)
    fiber = np.argmax(img @ normals.T, axis=1)
    assert np.allclose(np.sort(np.bincount(fiber, minlength=20)), 3)

    order = []
    for f in range(20):
        members = np.where(fiber == f)[0]
        traces = np.einsum('aii->a', Rs[members])
        rep = members[int(np.argmax(traces))]
        gammas = []
        for m in members:
            D = Rs[rep].T @ Rs[m]
            c = (np.trace(D) - 1) / 2
            s = (np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                           D[1, 0] - D[0, 1]]) / 2) @ n0
            gammas.append(np.arctan2(s, np.clip(c, -1, 1)) % (2 * np.pi))
        order.extend(members[np.argsort(np.round(gammas, 6))])
    Rs = Rs[np.array(order)]

    id_idx = int(np.argmax(np.einsum('aii->a', Rs)))
    assert np.allclose(Rs[id_idx], np.eye(3), atol=1e-9)
    assert id_idx == f0 * GAMMA_SIZE

    nbr_anchor_idx = []
    for fa in adj[f0]:
        for g in range(GAMMA_SIZE):
            nbr_anchor_idx.append(fa * GAMMA_SIZE + g)
    for g in range(GAMMA_SIZE):
        nbr_anchor_idx.append(f0 * GAMMA_SIZE + g)
    Q = Rs[np.array(nbr_anchor_idx, dtype=np.int64)]          # [12, 3, 3]

    prod = np.einsum('aij,kjl->akil', Rs, Q).reshape(-1, 9)
    d = np.abs(prod[:, None, :] - Rs.reshape(-1, 9)[None]).sum(-1)
    assert d.min(axis=1).max() < 1e-6
    trace_idx = np.argmin(d, axis=1).reshape(60, len(Q))

    return {
        'anchors': Rs.astype(np.float32),
        'identity_idx': id_idx,
        'trace_idx': trace_idx.astype(np.int32),
    }


def _group(convention: str):
    if convention == 'reference':
        from . import ref_convention
        return ref_convention.build()
    return _build_group()


def _active():
    return _group(_CONVENTION)


def get_anchors_full() -> np.ndarray:
    """All 60 anchor rotation matrices of the convention in force, float32
    [60, 3, 3]."""
    return _active()['anchors']


def get_identity_index() -> int:
    """Index of the identity anchor (0 under 'native', 29 under
    'reference'); an exact identity either way."""
    return _active()['identity_idx']


def get_intra_idx() -> np.ndarray:
    """[60, 12] int32 intra-conv anchor adjacency of the convention in
    force."""
    return _active()['trace_idx']


def get_intra_inv_idx() -> np.ndarray:
    """[60, 12] int32 inverse adjacency of the convention in force: inv[x,
    k] is the one anchor a with trace_idx[a, k] == x (each column of
    trace_idx is a permutation), so the intra conv's input gradient is the
    intra conv over inv."""
    return _inverse_adjacency(_CONVENTION)


@functools.lru_cache(maxsize=None)
def _inverse_adjacency(convention: str) -> np.ndarray:
    ti = _group(convention)['trace_idx']
    na, nk = ti.shape
    inv = np.full((na, nk), -1, np.int32)
    for k in range(nk):
        if sorted(ti[:, k]) != list(range(na)):
            raise ValueError(f'trace_idx column {k} is not a permutation')
        inv[ti[:, k], k] = np.arange(na, dtype=np.int32)
    return inv


def select_anchors(anchors: np.ndarray, k: int) -> np.ndarray:
    """Anchor subsets for kanchor in {1, 20, 40, 60}; k = 1 takes the
    identity anchor of the convention in force."""
    if k == 1:
        return anchors[get_identity_index()][None]
    if k == 20:
        return anchors[::3]
    if k == 40:
        return anchors.reshape(20, 3, 3, 3)[:, :2].reshape(-1, 3, 3)
    if k == 60:
        return anchors
    raise ValueError(f'kanchor must be one of {{1,20,40,60}}, got {k}')


def get_anchors(k: int = 60) -> np.ndarray:
    return select_anchors(get_anchors_full(), k)


def anchor_subset_relabel_map(k: int) -> np.ndarray:
    """[60] int32: for each full-group anchor label, the nearest anchor of
    the k-subset (argmax of tr(R_full R_sub^T), the least rotation
    distance). The datasets label rotations over all 60 anchors; at
    kanchor < 60 the attention logits span only the subset, so the loss
    relabels into it (JAX ``ops/icosahedron.py:anchor_subset_relabel_map``)."""
    full = get_anchors_full().astype(np.float64)
    sub = select_anchors(full, k)
    tr = np.einsum('aij,bij->ab', full, sub)
    return np.argmax(tr, axis=1).astype(np.int32)
