"""Point sampling and neighborhoods (counterpart of
``epn_pointcloud_tpu/ops/sampling.py``).

Layout: xyz [b, p, 3]; feats [b, p, a, c]. Furthest point sampling and the
ball query go through their kernel wrappers (``ops/kernels``): the CUDA
kernels for tensors on the card, the plain versions on the CPU, or the plain
versions everywhere inside ``kernels.plain()``.
"""

from __future__ import annotations

import math

import torch

from . import icosahedron, kernels
from .kernels import ball_query as _bq
from .kernels import fps as _fps

SHADOW_COORD = 1e4
FPS_SHADOW_EPS = 1e-3


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [b, n, ...], idx [b, m1(, m2, ...)] -> [b, m1(, m2, ...), ...]."""
    b = feats.shape[0]
    bi = torch.arange(b, device=feats.device).reshape(
        (b,) + (1,) * (idx.dim() - 1))
    return feats[bi, idx.long()]


def furthest_point_sampling(xyz: torch.Tensor, n_sample: int) -> torch.Tensor:
    """xyz [b, n, 3] -> int32 idx [b, n_sample]; the first sample is index 0
    and points with squared norm <= 1e-3 are never picked."""
    xyz = xyz.contiguous()
    if kernels.plain_forced():
        return _fps.fps_plain(xyz, n_sample, FPS_SHADOW_EPS)
    return _fps.fps(xyz, n_sample, FPS_SHADOW_EPS)


def furthest_sample(xyz: torch.Tensor, n_sample: int,
                    lazy_sample: bool = True):
    """idx [b, n_sample], sampled xyz [b, n_sample, 3]. ``lazy_sample`` (or
    n == n_sample) takes the first n_sample points."""
    b, n, _ = xyz.shape
    if lazy_sample or n == n_sample:
        idx = torch.arange(n_sample, dtype=torch.int32,
                           device=xyz.device).expand(b, n_sample)
        return idx, xyz[:, :n_sample]
    idx = furthest_point_sampling(xyz, n_sample)
    return idx, gather_points(xyz, idx)


def ball_query(query: torch.Tensor, support: torch.Tensor, radius: float,
               n_sample: int) -> torch.Tensor:
    """First ``n_sample`` support indices (index order) with d^2 < r^2,
    periodically repeat-filled. query [b, m, 3], support [b, n, 3] ->
    int32 [b, m, n_sample]. Under the reference anchor convention (read at
    each call) the fill is the original EPN kernel's: exactly n_sample - 1
    hits leave the last slot 0."""
    query, support = query.contiguous(), support.contiguous()
    ref_fill = icosahedron.get_convention() == 'reference'
    fn = _bq.ball_query_plain if kernels.plain_forced() else _bq.ball_query
    return fn(query, support, radius, n_sample, ref_fill)


def add_shadow_point(xyz: torch.Tensor) -> torch.Tensor:
    """[b, n, 3] -> [b, n+1, 3] with a far-away shadow coordinate."""
    shadow = xyz.new_full((xyz.shape[0], 1, xyz.shape[2]), SHADOW_COORD)
    return torch.cat([xyz, shadow], dim=1)


def add_shadow_feature(feats: torch.Tensor) -> torch.Tensor:
    """[b, n, a, c] -> [b, n+1, a, c] with a zero shadow feature."""
    b, _, a, c = feats.shape
    return torch.cat([feats, feats.new_zeros(b, 1, a, c)], dim=1)


def inter_grouping_ball(xyz: torch.Tensor, stride: int, radius: float,
                        n_neighbor: int, lazy_sample: bool = True):
    """FPS(stride) -> ball query -> localized neighbor coordinates.

    xyz [b, p1, 3] -> grouped_xyz [b, p2, nn, 3] (relative to the sample
    centers), ball_idx [b, p2, nn], sample_idx [b, p2], sample_xyz
    [b, p2, 3], where p2 = ceil(p1 / stride).
    """
    if n_neighbor <= 0:
        raise ValueError(f'n_neighbor={n_neighbor}; the builder arithmetic '
                         f'degenerates for small input_num')
    p1 = xyz.shape[1]
    n_sample = math.ceil(p1 / stride)
    sample_idx, sample_xyz = furthest_sample(xyz, n_sample, lazy_sample)
    ball_idx = ball_query(sample_xyz, xyz, radius, n_neighbor)
    grouped_xyz = gather_points(add_shadow_point(xyz), ball_idx)
    grouped_xyz = grouped_xyz - sample_xyz[:, :, None, :]
    return grouped_xyz, ball_idx, sample_idx, sample_xyz
