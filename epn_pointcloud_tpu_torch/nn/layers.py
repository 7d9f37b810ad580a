"""Core equivariant layers (counterpart of ``epn_pointcloud_tpu/nn/layers.py``),
channels-last [b, p, a, c].

Parameters keep the original EPN shapes and names, so a state_dict maps onto
the JAX variable tree through ``epn_pointcloud_tpu/compat.py``:

  * BasicSO3Conv ``W``      [c_out, c_in * k] (view of [c_out, c_in, k])
  * Dense1x1 ``weight``     [c_out, c_in, 1, 1] (Conv2d), [c_out, c_in, 1]
                            (Conv1d) or [c_out, c_in] (Linear), ``bias`` [c_out]
  * BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var``

Initialization follows the same rules (``init_parameters``): SO(3) conv
weights xavier-normal with gain sqrt(2) and torch fans (c*k, d*k); 1x1 convs
kaiming-uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in)) for weight and bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import icosahedron, kernel_points, so3conv
from ..ops.so3conv import SphericalPointCloud

KERNEL_CONDENSE_RATIO = kernel_points.KERNEL_CONDENSE_RATIO


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """torch's leaky ReLU, slope 0.01 (its subgradient at 0 is the slope,
    which the JAX package had to patch in by hand)."""
    return F.leaky_relu(x, 0.01)


def get_activation(name: str):
    if name != 'leaky_relu':
        raise NotImplementedError(f'activation {name!r} is not ported '
                                  f'(the builder uses leaky_relu)')
    return leaky_relu


class Dense1x1(nn.Module):
    """Channel-wise dense layer == Conv2d/Conv1d with a 1-wide kernel, or
    Linear, over the last axis."""

    SHAPES = {'conv2d': (1, 1), 'conv1d': (1,), 'linear': ()}

    def __init__(self, c_in: int, c_out: int, kind: str = 'conv2d'):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.weight = nn.Parameter(
            torch.empty((c_out, c_in) + self.SHAPES[kind]))
        self.bias = nn.Parameter(torch.empty(c_out))

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.c_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            self.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.reshape(self.c_out, self.c_in).t() + self.bias


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) over [b, p, a, c]: each (b, c) slice is
    normalized over (p, a) with its biased two-pass variance."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(1, 2), correction=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, affine. Train mode
    normalizes with the biased batch variance and moves the running
    statistics by momentum 0.1 with the unbiased one (torch semantics, as
    the JAX package's ``BatchNorm``); eval mode uses the running
    statistics."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def reset_parameters(self, gen: torch.Generator = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            c = x.shape[-1]
            y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=True, momentum=self.momentum,
                             eps=self.eps)
            return y.reshape(x.shape)
        rsig = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * rsig * self.weight + self.bias


class BasicSO3Conv(nn.Module):
    """The learned SO(3) conv weight, stored as the original [d, c*k]."""

    def __init__(self, dim_in: int, dim_out: int, n_kernel: int):
        super().__init__()
        self.dim_in, self.dim_out, self.n_kernel = dim_in, dim_out, n_kernel
        self.W = nn.Parameter(torch.empty(dim_out, dim_in * n_kernel))

    def reset_parameters(self, gen: torch.Generator):
        fan = self.dim_in * self.n_kernel + self.dim_out * self.n_kernel
        std = math.sqrt(2.0) * math.sqrt(2.0 / fan)
        with torch.no_grad():
            self.W.normal_(0.0, std, generator=gen)

    def weight_kcd(self) -> torch.Tensor:
        """[k, c_in, c_out] view used by the kernels."""
        return self.W.reshape(self.dim_out, self.dim_in, self.n_kernel) \
            .permute(2, 1, 0).contiguous()


def _const(x) -> torch.Tensor:
    return torch.as_tensor(x).clone()


class InterSO3Conv(nn.Module):
    """Spatial SO(3)-anchor conv: ball grouping + anchor-rotated kernel
    weights + learned conv product (fused path of the JAX package)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 stride: int, radius: float, sigma: float, n_neighbor: int,
                 lazy_sample: bool = True, kanchor: int = 60):
        super().__init__()
        self.stride, self.radius, self.sigma = stride, radius, sigma
        self.n_neighbor, self.lazy_sample = n_neighbor, lazy_sample
        kernels_ = kernel_points.get_spherical_kernel_points(
            KERNEL_CONDENSE_RATIO * radius, kernel_size)
        self.register_buffer('anchors', _const(icosahedron.get_anchors(kanchor)),
                             persistent=False)
        self.register_buffer('kernels', _const(kernels_), persistent=False)
        self.basic_conv = BasicSO3Conv(dim_in, dim_out, kernels_.shape[0])

    def forward(self, x: SphericalPointCloud, ones_input: bool = False):
        _, xyz, feats, sample_idx = so3conv.inter_so3conv_fused(
            x.xyz, x.feats, self.stride, self.n_neighbor, self.anchors,
            self.kernels, self.radius, self.sigma,
            self.basic_conv.weight_kcd(), lazy_sample=self.lazy_sample,
            ones_input=ones_input)
        return sample_idx, SphericalPointCloud(xyz, feats, self.anchors)


class IntraSO3Conv(nn.Module):
    """Rotation-group conv over the 60x12 group adjacency (kanchor 60)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        ti = icosahedron.get_intra_idx()
        self.register_buffer('trace_idx', _const(ti.astype('int32')),
                             persistent=False)
        self.register_buffer('inv_idx',
                             _const(icosahedron.get_intra_inv_idx()),
                             persistent=False)
        self.register_buffer('anchors', _const(icosahedron.get_anchors(60)),
                             persistent=False)
        self.basic_conv = BasicSO3Conv(dim_in, dim_out, ti.shape[1])

    def forward(self, x: SphericalPointCloud) -> SphericalPointCloud:
        out = so3conv.intra_so3conv(x.feats, self.trace_idx, self.inv_idx,
                                    self.basic_conv.weight_kcd())
        return SphericalPointCloud(x.xyz, out, self.anchors)


class PointnetSO3Conv(nn.Module):
    """Equivariant PointNet: concat per-anchor rotated coordinates, 1x1
    conv, max over points. -> [b, a, c_out]."""

    def __init__(self, dim_in: int, dim_out: int, kanchor: int = 60):
        super().__init__()
        self.register_buffer('anchors', _const(icosahedron.get_anchors(kanchor)),
                             persistent=False)
        self.embed = Dense1x1(dim_in + 3, dim_out)

    def forward(self, x: SphericalPointCloud) -> torch.Tensor:
        xyzr = so3conv.pointnet_so3_coords(x.xyz, self.anchors)
        feats = self.embed(torch.cat([x.feats, xyzr], dim=-1))
        return feats.max(dim=1).values


def init_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init of every parameter, in module registration order."""
    for m in module.modules():
        if isinstance(m, (Dense1x1, BatchNorm, BasicSO3Conv)):
            m.reset_parameters(gen)
