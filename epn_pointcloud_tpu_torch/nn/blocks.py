"""Conv blocks (counterpart of ``epn_pointcloud_tpu/nn/blocks.py``, eval
path, fp32, unpacked [b, p, a, c] activations).

Module names follow the original EPN tree
(``backbone.{i}.blocks.{j}.{inter_conv,intra_conv,skip_conv,norm}``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from torch import nn

from ..ops import sampling
from ..ops.so3conv import SphericalPointCloud
from .layers import (BatchNorm, Dense1x1, InstanceNorm, InterSO3Conv,
                     IntraSO3Conv, get_activation)


def _check_norm(norm):
    if norm not in ('BatchNorm2d', 'BatchNorm1d'):
        raise NotImplementedError(f'norm {norm!r} is not ported')


class IntraSO3ConvBlock(nn.Module):
    """intra conv + InstanceNorm + activation."""

    def __init__(self, dim_in: int, dim_out: int, activation='leaky_relu'):
        super().__init__()
        self.conv = IntraSO3Conv(dim_in, dim_out)
        self.norm = InstanceNorm()
        self.act = get_activation(activation)

    def forward(self, x: SphericalPointCloud) -> SphericalPointCloud:
        x = self.conv(x)
        return SphericalPointCloud(x.xyz, self.act(self.norm(x.feats)),
                                   x.anchors)


class InterSO3ConvBlock(nn.Module):
    """inter conv + BatchNorm + activation."""

    def __init__(self, dim_in, dim_out, kernel_size, stride, radius, sigma,
                 n_neighbor, kanchor=60, lazy_sample=None, norm=None,
                 activation='leaky_relu', pooling=None, **_unused):
        super().__init__()
        if pooling not in (None, 'none'):
            raise NotImplementedError(f'xyz pooling {pooling!r} is not ported')
        _check_norm(norm)
        lazy = True if lazy_sample is None else lazy_sample
        self.conv = InterSO3Conv(dim_in, dim_out, kernel_size, stride, radius,
                                 sigma, n_neighbor, lazy_sample=lazy,
                                 kanchor=kanchor)
        self.norm = BatchNorm(dim_out)
        self.act = get_activation(activation)

    def forward(self, x: SphericalPointCloud, ones_input: bool = False):
        sample_idx, x = self.conv(x, ones_input=ones_input)
        return sample_idx, SphericalPointCloud(
            x.xyz, self.act(self.norm(x.feats)), x.anchors)


class SeparableSO3ConvBlock(nn.Module):
    """inter -> intra with a 1x1-conv skip connection (gathered through
    sample_idx when strided), BatchNorm + activation, residual add."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        p = args
        if p['kanchor'] != 60:
            raise NotImplementedError('separable blocks need kanchor 60')
        if p.get('dropout_rate', 0) > 0:
            raise NotImplementedError('dropout is not ported')
        _check_norm(p.get('norm'))
        self.stride = p['stride']
        self.inter_conv = InterSO3ConvBlock(**p)
        self.intra_conv = IntraSO3ConvBlock(p['dim_out'], p['dim_out'],
                                            p['activation'])
        self.skip_conv = Dense1x1(p['dim_in'], p['dim_out'])
        self.norm = BatchNorm(p['dim_out'])
        self.act = get_activation(p['activation'])

    def forward(self, x: SphericalPointCloud, ones_input: bool = False):
        skip = x.feats
        sample_idx, x = self.inter_conv(x, ones_input=ones_input)
        x = self.intra_conv(x)
        if self.stride > 1:
            if ones_input:
                # gathering an all-ones field is the identity: rebuild the
                # constant at the strided point count
                skip = skip.new_ones((skip.shape[0], x.xyz.shape[1])
                                     + skip.shape[2:])
            else:
                skip = sampling.gather_points(skip, sample_idx)
        skip = self.act(self.norm(self.skip_conv(skip)))
        return SphericalPointCloud(x.xyz, x.feats + skip, x.anchors)


class BasicSO3ConvBlock(nn.Module):
    """Sequencer over the separable layers of one backbone block.

    The fused inter conv recomputes its grouping in every layer (as the JAX
    package's fused path does), so no neighbor cache is carried between
    layers."""

    def __init__(self, params: Sequence[Dict[str, Any]]):
        super().__init__()
        for prm in params:
            if prm['type'] != 'separable_block':
                raise NotImplementedError(f'block type {prm["type"]!r} is not '
                                          f'ported (kanchor 60 only)')
        self.blocks = nn.ModuleList(SeparableSO3ConvBlock(prm['args'])
                                    for prm in params)

    def forward(self, x: SphericalPointCloud,
                ones_input: bool = False) -> SphericalPointCloud:
        for i, blk in enumerate(self.blocks):
            x = blk(x, ones_input=ones_input and i == 0)
        return x
