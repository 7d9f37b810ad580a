"""SO(3)-anchor convolution functional core (counterpart of
``epn_pointcloud_tpu/ops/so3conv.py``, fp32 path).

Layout: xyz [b, p, 3]; feats [b, p, a, c].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import kernels, sampling
from .kernels import inter_conv as _ic
from .kernels import intra_conv as _intra


class SphericalPointCloud(NamedTuple):
    """xyz [b, p, 3]; feats [b, p, a, c]; anchors [a, 3, 3] or None."""
    xyz: torch.Tensor
    feats: torch.Tensor
    anchors: Optional[torch.Tensor]


def preprocess_input(x: torch.Tensor, na: int) -> SphericalPointCloud:
    """[b, p, 3] -> SphericalPointCloud with occupancy-ones features
    [b, p, na, 1] (the model's call, add_center=False, of the JAX
    ``preprocess_input``)."""
    if x.shape[-1] != 3:
        raise NotImplementedError('normals input (6 channels) is not ported')
    b, p, _ = x.shape
    return SphericalPointCloud(x, x.new_ones(b, p, na, 1), None)


def rotated_kernels(anchors: torch.Tensor, kernels_: torch.Tensor):
    """(rk [a, k, 3] = R_a kappa_k, k2 [k] = |kappa_k|^2)."""
    rk = torch.einsum('aij,kj->aki', anchors, kernels_).contiguous()
    return rk, (kernels_ ** 2).sum(-1).contiguous()


def inter_so3conv_fused(xyz: torch.Tensor, feats: torch.Tensor, stride: int,
                        n_neighbor: int, anchors: torch.Tensor,
                        kernels_: torch.Tensor, radius: float, sigma: float,
                        W: torch.Tensor, lazy_sample: bool = True,
                        ones_input: bool = False):
    """Grouping + anchor weights + neighbor contraction + the learned
    BasicSO3Conv product. W: [k, c_in, c_out].

    Returns (inter_idx, new_xyz, out [b, p2, a, c_out], sample_idx).

    The occupancy-ones input of block 0 (c_in == 1) runs in plain torch as
    in the JAX fp32 path, differentiated by autograd: every gathered feature
    is 1, so the contraction is the anchor-weight sum. Every layer with a
    real feature table goes through ``InterConvFn`` (the kernels, or the
    plain versions on the CPU); inside ``kernels.plain()`` it calls the plain
    forward and lets autograd differentiate it, so the card's plain path
    shares no backward formula with the kernel path.
    """
    grouped_xyz, inter_idx, sample_idx, new_xyz = \
        sampling.inter_grouping_ball(xyz, stride, radius, n_neighbor,
                                     lazy_sample)
    rk, k2 = rotated_kernels(anchors, kernels_)
    na = anchors.shape[0]
    if ones_input and feats.shape[-1] == 1:
        outs = []
        for s in range(0, na, _ic.ANCHOR_CHUNK):
            w = _ic.anchor_weights(grouped_xyz, rk[s:s + _ic.ANCHOR_CHUNK],
                                   k2, sigma)                   # [b,p,n,ac,k]
            F = w.sum(dim=2)                                    # [b,p,ac,k]
            outs.append(torch.einsum('bpak,kd->bpad', F, W[:, 0, :]))
        return inter_idx, new_xyz, torch.cat(outs, dim=2), sample_idx
    args = (grouped_xyz.contiguous(), inter_idx, feats.contiguous(), rk, k2,
            W.contiguous(), float(sigma))
    if kernels.plain_forced():
        out = _ic.inter_conv_plain(*args)
    else:
        out = _ic.InterConvFn.apply(*args)
    return inter_idx, new_xyz, out, sample_idx


def intra_so3conv(feats: torch.Tensor, trace_idx: torch.Tensor,
                  inv_idx: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Rotation-group conv over the 60x12 adjacency: feats [b, p, 60, c],
    trace_idx and its inverse inv_idx [60, 12] int32, W [12, c, d] ->
    [b, p, 60, d]. Through ``IntraConvFn``, or the plain forward under
    autograd inside ``kernels.plain()``."""
    feats, W = feats.contiguous(), W.contiguous()
    if kernels.plain_forced():
        return _intra.intra_conv_plain(feats, trace_idx, W)
    return _intra.IntraConvFn.apply(feats, trace_idx, inv_idx, W)


def pointnet_so3_coords(xyz: torch.Tensor, anchors: torch.Tensor):
    """Per-anchor inversely-rotated centered coordinates:
    [b, p, 3] x [a, 3, 3] -> [b, p, a, 3]."""
    xyz = xyz - xyz.mean(dim=1, keepdim=True)
    return torch.einsum('aji,bpj->bpai', anchors, xyz)
