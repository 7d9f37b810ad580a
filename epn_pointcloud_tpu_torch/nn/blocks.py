"""Conv blocks (counterpart of ``epn_pointcloud_tpu/nn/blocks.py``), over
[b, p, a, c] activations. The inter conv's and the skip's norm is the one
the block parameters name: BatchNorm (cls) or, with no name, InstanceNorm
(inv; no parameters). In fp32, train and eval differ only in the
BatchNorms, through ``module.train()`` / ``.eval()``. In the bf16 production
mode (``ops.so3conv.packed_enabled()``) a separable block runs the JAX
packed path: the inter conv's norm and activation are deferred into the
intra conv's load path (PRENORM kernel; the fold carries the statistics of
the batch, BatchNorm in train mode, or of each sample, InstanceNorm, and
takes their gradient). In eval a BatchNorm block runs the intra
InstanceNorm, the skip 1x1 conv, its BatchNorm, both activations and the
residual add in one fused tail kernel; training (whose skip BatchNorm needs
the skip conv's batch statistics), InstanceNorm blocks (the JAX package
fuses the tail for BatchNorm only) and block 0 layer 0 (the occupancy-ones
input, rank-1 skip) keep the unfused tail.

With a dropout rate > 0 the inter and the intra block drop after their
activation in train mode (``layers.Dropout``), and, as in the JAX package,
nothing is deferred: the inter norm runs on its own before the plain intra
conv (not the PRENORM kernel), the intra norm on its own, and eval runs
the unfused tail (no fused tail kernel).

Below 60 anchors (kanchor 40, 20, or 1 for the KPConv baseline) the
builders sequence ``inter_block`` layers: an inter conv, its norm over the
kanchor anchors and the activation. In the production mode its norm takes
the packed statistics (the moments kernel) where the JAX package packs,
kanchor > 1; kanchor 1 stays unpacked (plain-torch statistics).

Module names follow the original EPN tree
(``backbone.{i}.blocks.{j}.{inter_conv,intra_conv,skip_conv,norm}``, and
``backbone.{i}.blocks.{j}.{conv,norm}`` for an inter block).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from torch import nn

from ..ops import sampling, so3conv
from ..ops.so3conv import SphericalPointCloud
from .layers import (BatchNorm, Dense1x1, Dropout, InstanceNorm,
                     InterSO3Conv, IntraSO3Conv, get_activation, make_norm)


class IntraSO3ConvBlock(nn.Module):
    """intra conv + InstanceNorm + activation + dropout."""

    def __init__(self, dim_in: int, dim_out: int, activation='leaky_relu',
                 dropout_rate: float = 0.0):
        super().__init__()
        self.conv = IntraSO3Conv(dim_in, dim_out)
        self.norm = InstanceNorm()
        self.act = get_activation(activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: SphericalPointCloud, prenorm=None,
                defer_norm_act: bool = False):
        """prenorm: the preceding norm's fold for the conv's load path.
        defer_norm_act: return (raw conv output, its InstanceNorm folded to
        per-lane [b, 2, L]) for a fused tail to apply."""
        x = self.conv(x, prenorm=prenorm)
        if defer_norm_act:
            return x, self.norm.scale_shift(x.feats.shape[2], x.feats)
        return SphericalPointCloud(
            x.xyz, self.dropout(self.act(self.norm(x.feats))), x.anchors)


class InterSO3ConvBlock(nn.Module):
    """inter conv + norm (BatchNorm, or InstanceNorm when none is named) +
    activation + dropout."""

    def __init__(self, dim_in, dim_out, kernel_size, stride, radius, sigma,
                 n_neighbor, kanchor=60, lazy_sample=None, norm=None,
                 activation='leaky_relu', pooling=None, dropout_rate=0.0,
                 **_unused):
        super().__init__()
        if pooling not in (None, 'none'):
            raise NotImplementedError(f'xyz pooling {pooling!r} is not ported')
        lazy = True if lazy_sample is None else lazy_sample
        self.conv = InterSO3Conv(dim_in, dim_out, kernel_size, stride, radius,
                                 sigma, n_neighbor, lazy_sample=lazy,
                                 kanchor=kanchor)
        self.norm = make_norm(norm, dim_out)
        self.act = get_activation(activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: SphericalPointCloud, ones_input: bool = False,
                defer_norm_act: bool = False):
        """defer_norm_act: return (sample_idx, raw conv output, the norm
        folded to per-lane [1, 2, L] (BatchNorm) or [b, 2, L]
        (InstanceNorm)) for the next kernel to apply with the activation on
        load."""
        sample_idx, x = self.conv(x, ones_input=ones_input)
        if defer_norm_act:
            return sample_idx, x, self.norm.scale_shift(x.feats.shape[2],
                                                        x.feats)
        # one anchor is the JAX package's unpacked layout: its statistics
        # come from plain torch sums, not the moments kernel
        feats = self.norm(x.feats, kernel_stats=x.feats.shape[2] > 1)
        return sample_idx, SphericalPointCloud(
            x.xyz, self.dropout(self.act(feats)), x.anchors)


class SeparableSO3ConvBlock(nn.Module):
    """inter -> intra with a 1x1-conv skip connection (gathered through
    sample_idx when strided), norm + activation, residual add."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        p = args
        if p['kanchor'] != 60:
            raise NotImplementedError('separable blocks need kanchor 60')
        self.stride = p['stride']
        rate = p.get('dropout_rate', 0.0)
        # the JAX package's gates: with dropout nothing is deferred
        self.defer = rate == 0
        self.inter_conv = InterSO3ConvBlock(**p)
        self.intra_conv = IntraSO3ConvBlock(p['dim_out'], p['dim_out'],
                                            p['activation'], rate)
        self.skip_conv = Dense1x1(p['dim_in'], p['dim_out'])
        self.norm = make_norm(p.get('norm'), p['dim_out'])
        self.act = get_activation(p['activation'])

    def forward(self, x: SphericalPointCloud, ones_input: bool = False):
        if so3conv.packed_enabled():
            return self._forward_packed(x, ones_input)
        skip = x.feats
        sample_idx, x = self.inter_conv(x, ones_input=ones_input)
        x = self.intra_conv(x)
        skip = self._strided_skip(skip, x, sample_idx, ones_input)
        skip = self.act(self.norm(self.skip_conv(skip)))
        return SphericalPointCloud(x.xyz, x.feats + skip, x.anchors)

    def _strided_skip(self, skip, x, sample_idx, ones_input):
        if self.stride == 1:
            return skip
        if ones_input:
            # gathering an all-ones field is the identity: rebuild the
            # constant at the strided point count
            return skip.new_ones((skip.shape[0], x.xyz.shape[1])
                                 + skip.shape[2:])
        return sampling.gather_points(skip, sample_idx)

    def _forward_packed(self, x: SphericalPointCloud, ones_input: bool):
        """The bf16 production-mode forward (``blocks.py:126-246`` of the
        JAX package on packed activations). Its fused tail needs an eval
        BatchNorm skip (``blocks.py:182-186``); with dropout neither the
        inter norm nor the tail is deferred (``fuse``, ``blocks.py:141-142``).
        """
        skip = so3conv.at_use(x.feats)
        if self.defer:
            sample_idx, x, inter_ss = self.inter_conv(
                x, ones_input=ones_input, defer_norm_act=True)
        else:
            (sample_idx, x), inter_ss = self.inter_conv(
                x, ones_input=ones_input), None
        skip = self._strided_skip(skip, x, sample_idx, ones_input)
        if (not self.defer or ones_input or self.training
                or not isinstance(self.norm, BatchNorm)):
            # the unfused tail, rounded after the skip conv, after each norm
            # and after the residual. The rank-1 skip over the constant field
            # is the JAX package's unpacked one: a broadcast product and
            # plain-torch statistics; the others run the grouped conv and
            # take their statistics from the moments kernel
            x = self.intra_conv(x, prenorm=inter_ss)
            if ones_input:
                skip = self.norm(self.skip_conv(skip), kernel_stats=False)
            else:
                skip = self.norm(self.skip_conv.grouped(skip))
            return SphericalPointCloud(x.xyz, x.feats + self.act(skip),
                                       x.anchors)
        y, main_ss = self.intra_conv(x, prenorm=inter_ss, defer_norm_act=True)
        feats = so3conv.separable_tail(
            skip, self.skip_conv.weight_cd(), self.skip_conv.bias,
            self.norm.scale_shift(y.feats.shape[2]), y.feats, main_ss)
        return SphericalPointCloud(y.xyz, feats, y.anchors)


class BasicSO3ConvBlock(nn.Module):
    """Sequencer over the layers of one backbone block: separable blocks
    (kanchor 60) or inter blocks (``inter_block``, kanchor < 60).

    The fused inter conv recomputes its grouping in every layer (as the JAX
    package's fused path does: it returns no ``inter_w``), so no neighbor
    cache is carried between layers."""

    def __init__(self, params: Sequence[Dict[str, Any]]):
        super().__init__()
        blocks = []
        for prm in params:
            if prm['type'] == 'separable_block':
                blocks.append(SeparableSO3ConvBlock(prm['args']))
            elif prm['type'] in ('inter', 'inter_block'):
                blocks.append(InterSO3ConvBlock(**prm['args']))
            else:
                raise NotImplementedError(f'block type {prm["type"]!r} is not '
                                          f'ported')
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: SphericalPointCloud,
                ones_input: bool = False) -> SphericalPointCloud:
        for i, blk in enumerate(self.blocks):
            x = blk(x, ones_input=ones_input and i == 0)
            if isinstance(blk, InterSO3ConvBlock):
                x = x[1]
        return x
