"""SO(3)-anchor convolution functional core (counterpart of
``epn_pointcloud_tpu/ops/so3conv.py``) and the compute-precision policy.

Layout: xyz [b, p, 3]; feats [b, p, a, c]. A contiguous [b, p, 60, c]
tensor is the JAX package's packed [b, p, 60*c] layout in memory, so the
bf16 mode takes the packed path's numerics with no layout switch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import kernels, sampling
from .kernels import grouped_conv as _gc
from .kernels import inter_conv as _ic
from .kernels import intra_conv as _intra
from .kernels import moments as _mom
from .kernels import ones_conv as _ones

# Compute precision of the conv path (``set_compute_dtype``). fp32 is the
# parity mode; bf16 is the production mode: activations and conv / 1x1
# weights are bf16 at use (parameters stay fp32 in the modules), every
# product accumulates in fp32, and norm statistics, scale/shift folds and
# the head's attention and logits are fp32.
_DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}
_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(name: str) -> None:
    """Set the process-wide compute dtype ('fp32' or 'bf16'), as the JAX
    package's trainer does at start-up."""
    global _COMPUTE_DTYPE
    if name not in _DTYPES:
        raise ValueError(f'compute dtype {name!r}: fp32 or bf16')
    _COMPUTE_DTYPE = _DTYPES[name]


def get_compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def packed_enabled() -> bool:
    """True exactly in the bf16 production mode: the blocks defer their
    norms into the next kernel and run the fused eval tail, and the norm
    statistics come from the moments kernel (the JAX packed path)."""
    return _COMPUTE_DTYPE == torch.bfloat16


def at_use(t: torch.Tensor) -> torch.Tensor:
    """t in the type it is used in: bf16 in the production mode, else its
    own (fp32, or the fp64 of a float64 reference model)."""
    return t.to(torch.bfloat16) if packed_enabled() else t


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
    BasicSO3Conv product, in the compute dtype. W: [k, c_in, c_out] fp32
    (cast at use).

    Returns (inter_idx, new_xyz, out [b, p2, a, c_out], sample_idx).

    The occupancy-ones input of block 0 (c_in == 1) runs the ones kernel:
    every gathered feature is 1, so the contraction is the anchor-weight sum
    F [b, p2, a, k] (no gradient: it depends on the coordinates only), and
    the learned [k, c_out] product is one torch matmul under autograd, with
    fp32 accumulation. Every layer with a real feature table goes through
    ``InterConvFn`` (the kernels, or the plain versions on the CPU); inside
    ``kernels.plain()`` it calls the plain forward and lets autograd
    differentiate it, so the card's plain path shares no backward formula
    with the kernel path.
    """
    grouped_xyz, inter_idx, sample_idx, new_xyz = \
        sampling.inter_grouping_ball(xyz, stride, radius, n_neighbor,
                                     lazy_sample)
    rk, k2 = rotated_kernels(anchors, kernels_)
    if ones_input and feats.shape[-1] == 1:
        ones = _ones.ones_conv_plain if kernels.plain_forced() else \
            _ones.ones_conv
        W0 = at_use(W[:, 0, :])
        F = ones(grouped_xyz.contiguous(), rk, k2, float(sigma), W0.dtype)
        out = torch.matmul(F, W0)
        return inter_idx, new_xyz, out, sample_idx
    args = (grouped_xyz.contiguous(), inter_idx, at_use(feats).contiguous(),
            rk, k2, at_use(W).contiguous(), float(sigma))
    if kernels.plain_forced():
        out = _ic.inter_conv_plain(*args)
    else:
        out = _ic.InterConvFn.apply(*args)
    return inter_idx, new_xyz, out, sample_idx


def intra_so3conv(feats: torch.Tensor, trace_idx: torch.Tensor,
                  inv_idx: torch.Tensor, W: torch.Tensor,
                  prenorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotation-group conv over the 60x12 adjacency: feats [b, p, 60, c],
    trace_idx and its inverse inv_idx [60, 12] int32, W [12, c, d] fp32
    (cast at use) -> [b, p, 60, d] in the compute dtype. Through
    ``IntraConvFn``, or the plain forward under autograd inside
    ``kernels.plain()``.

    prenorm: the preceding inter conv's deferred norm, fp32 lanes
    [1 or b, 2, 60*c] (scale, shift), applied with the leaky ReLU on load
    (the PRENORM kernel, through ``IntraConvPrenormFn``; production
    mode)."""
    feats, W = at_use(feats).contiguous(), at_use(W).contiguous()
    if prenorm is not None:
        ss = prenorm.contiguous()
        if kernels.plain_forced():
            return _intra.intra_conv_prenorm_plain(feats, ss, trace_idx, W)
        return _intra.IntraConvPrenormFn.apply(feats, ss, trace_idx, inv_idx,
                                               W)
    if kernels.plain_forced():
        return _intra.intra_conv_plain(feats, trace_idx, W)
    return _intra.IntraConvFn.apply(feats, trace_idx, inv_idx, W)


def moments(x: torch.Tensor):
    """Per-lane (sum, sum of squares) fp32 [b, 60*c] of x [b, p, 60, c]
    over the points: the moments kernel through ``MomentsFn``, or its plain
    version inside ``kernels.plain()``; both differentiable."""
    b, p = x.shape[:2]
    x3 = x.contiguous().reshape(b, p, -1)
    if kernels.plain_forced():
        return _mom.moments_plain(x3)
    return _mom.MomentsFn.apply(x3)


def grouped_conv1x1(x: torch.Tensor, W: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """One [c, d] weight over every anchor of x [b, p, a, c], plus bias:
    the grouped-conv kernel through ``GroupedConvFn`` (W cast to x's type,
    bias fp32), or its plain version under autograd inside
    ``kernels.plain()``."""
    fn = _gc.grouped_conv_plain if kernels.plain_forced() else \
        _gc.GroupedConvFn.apply
    return fn(x.contiguous(), W.to(x.dtype).contiguous(), bias.float())


def separable_tail(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor,
                   ssk: torch.Tensor, y: torch.Tensor,
                   ssm: torch.Tensor) -> torch.Tensor:
    """The fused eval tail of a separable block,
    act(y * ssm0 + ssm1) + act((x @ W + bias) * ssk0 + ssk1), rounded once
    (the grouped-conv kernel's tail epilogue)."""
    fn = _gc.grouped_conv_tail_plain if kernels.plain_forced() else \
        _gc.grouped_conv_tail
    return fn(x.contiguous(), W.to(x.dtype).contiguous(), bias.float(),
              ssk.contiguous(), y.contiguous(), ssm.contiguous())


def pointnet_so3_coords(xyz: torch.Tensor, anchors: torch.Tensor):
    """Per-anchor inversely-rotated centered coordinates:
    [b, p, 3] x [a, 3, 3] -> [b, p, a, 3]."""
    xyz = xyz - xyz.mean(dim=1, keepdim=True)
    return torch.einsum('aji,bpj->bpai', anchors, xyz)
