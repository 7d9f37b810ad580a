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

The activation is any a block names (``layers.get_activation``); only the
ReLU and the leaky ReLU are deferred into the kernels (the PRENORM intra
conv, its backward and the fused tail take their slope), as in the JAX
package, and the others run after the kernel's output in plain torch.
With ``pooling`` ('stride' or 'no-stride') every inter conv runs the
unfused path (``so3conv.inter_so3conv_grouping``: the blur, the grouping,
the W-off F, the learned product as a torch matmul), and a block's
consecutive stride-1 layers share one grouping (``so3conv.GroupingCache``),
reset after any strided layer. A separable block at one anchor has no
intra conv (nothing deferred, no fused tail).

Module names follow the original EPN tree
(``backbone.{i}.blocks.{j}.{inter_conv,intra_conv,skip_conv,norm}``, and
``backbone.{i}.blocks.{j}.{conv,norm}`` for an inter block).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ..ops import sampling, so3conv
from ..ops.kernels.build import ACT_SLOPES
from ..ops.so3conv import SphericalPointCloud
from .layers import (BatchNorm, Dense1x1, Dropout, InstanceNorm,
                     InterSO3Conv, IntraSO3Conv, KernelPropagation,
                     get_activation, make_norm)


def _activate(act, x):
    """x through the activation ``act`` (None: as it is)."""
    return x if act is None else act(x)


class IntraSO3ConvBlock(nn.Module):
    """intra conv + InstanceNorm + activation + dropout (JAX defaults:
    ReLU, no dropout; ``norm`` is accepted and unused, as there: the intra
    block always normalizes by InstanceNorm)."""

    def __init__(self, dim_in: int, dim_out: int, norm=None,
                 activation: Optional[str] = 'relu',
                 dropout_rate: float = 0.0):
        super().__init__()
        self.conv = IntraSO3Conv(dim_in, dim_out)
        self.norm = InstanceNorm()
        self.act = get_activation(activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: SphericalPointCloud, prenorm=None,
                defer_norm_act: bool = False,
                slope: float = ACT_SLOPES['leaky_relu']):
        """prenorm: the preceding norm's fold for the conv's load path, with
        the preceding activation's ``slope``. defer_norm_act: return (raw
        conv output, its InstanceNorm folded to per-lane [b, 2, L]) for a
        fused tail to apply."""
        x = self.conv(x, prenorm=prenorm, slope=slope)
        if defer_norm_act:
            return x, self.norm.scale_shift(x.feats.shape[2], x.feats)
        return SphericalPointCloud(
            x.xyz, self.dropout(_activate(self.act, self.norm(x.feats))),
            x.anchors)


class InterSO3ConvBlock(nn.Module):
    """inter conv + norm (BatchNorm, or InstanceNorm when none is named) +
    activation + dropout (JAX defaults: ReLU, no pooling)."""

    def __init__(self, dim_in, dim_out, kernel_size, stride, radius, sigma,
                 n_neighbor, kanchor=60, lazy_sample=None, norm=None,
                 activation='relu', pooling='none', dropout_rate=0.0,
                 **_unused):
        super().__init__()
        lazy = True if lazy_sample is None else lazy_sample
        self.conv = InterSO3Conv(dim_in, dim_out, kernel_size, stride, radius,
                                 sigma, n_neighbor, lazy_sample=lazy,
                                 kanchor=kanchor, pooling=pooling)
        self.norm = make_norm(norm, dim_out)
        self.act = get_activation(activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: SphericalPointCloud, ones_input: bool = False,
                defer_norm_act: bool = False,
                cache: Optional[so3conv.GroupingCache] = None):
        """defer_norm_act: return (sample_idx, raw conv output, the norm
        folded to per-lane [1, 2, L] (BatchNorm) or [b, 2, L]
        (InstanceNorm)) for the next kernel to apply with the activation on
        load. cache: the block's shared grouping (``InterSO3Conv``)."""
        sample_idx, x = self.conv(x, ones_input=ones_input, cache=cache)
        if defer_norm_act:
            return sample_idx, x, self.norm.scale_shift(x.feats.shape[2],
                                                        x.feats)
        # one anchor is the JAX package's unpacked layout: its statistics
        # come from plain torch sums, not the moments kernel
        feats = self.norm(x.feats, kernel_stats=x.feats.shape[2] > 1)
        return sample_idx, SphericalPointCloud(
            x.xyz, self.dropout(_activate(self.act, feats)), x.anchors)


class SeparableSO3ConvBlock(nn.Module):
    """inter -> intra (above one anchor) with a 1x1-conv skip connection
    (gathered through sample_idx when strided), norm + activation, residual
    add."""

    def __init__(self, args: Dict[str, Any]):
        super().__init__()
        p = args
        self.stride = p['stride']
        rate = p.get('dropout_rate', 0.0)
        self.use_intra = p['kanchor'] > 1
        # the JAX package's gates (``fuse``): with dropout, at one anchor or
        # with an activation the kernels do not apply, nothing is deferred
        self.defer = (self.use_intra and rate == 0
                      and p['activation'] in ACT_SLOPES)
        self.slope = ACT_SLOPES.get(p['activation'])
        self.inter_conv = InterSO3ConvBlock(**p)
        if self.use_intra:
            self.intra_conv = IntraSO3ConvBlock(
                p['dim_out'], p['dim_out'], activation=p['activation'],
                dropout_rate=rate)
        self.skip_conv = Dense1x1(p['dim_in'], p['dim_out'])
        self.norm = make_norm(p.get('norm'), p['dim_out'])
        self.act = get_activation(p['activation'])

    def forward(self, x: SphericalPointCloud, ones_input: bool = False,
                cache: Optional[so3conv.GroupingCache] = None):
        if so3conv.packed_enabled() and self.use_intra:
            return self._forward_packed(x, ones_input, cache)
        skip = so3conv.at_use(x.feats)
        sample_idx, x = self.inter_conv(x, ones_input=ones_input, cache=cache)
        if self.use_intra:
            x = self.intra_conv(x)
        skip = self._strided_skip(skip, x, sample_idx, ones_input)
        # one anchor: the JAX package's unpacked statistics (plain sums)
        skip = self.act(self.norm(self.skip_conv(skip),
                                  kernel_stats=skip.shape[2] > 1))
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

    def _forward_packed(self, x: SphericalPointCloud, ones_input: bool,
                        cache: Optional[so3conv.GroupingCache]):
        """The bf16 production-mode forward (``blocks.py:126-246`` of the
        JAX package on packed activations). Its fused tail needs an eval
        BatchNorm skip (``blocks.py:182-186``); with dropout, or an
        activation other than the ReLU and the leaky ReLU, neither the
        inter norm nor the tail is deferred (``fuse``,
        ``blocks.py:141-142``)."""
        skip = so3conv.at_use(x.feats)
        if self.defer:
            sample_idx, x, inter_ss = self.inter_conv(
                x, ones_input=ones_input, defer_norm_act=True, cache=cache)
        else:
            (sample_idx, x), inter_ss = self.inter_conv(
                x, ones_input=ones_input, cache=cache), None
        skip = self._strided_skip(skip, x, sample_idx, ones_input)
        if (not self.defer or ones_input or self.training
                or not isinstance(self.norm, BatchNorm)):
            # the unfused tail, rounded after the skip conv, after each norm
            # and after the residual. The rank-1 skip over the constant field
            # is the JAX package's unpacked one: a broadcast product and
            # plain-torch statistics; the others run the grouped conv and
            # take their statistics from the moments kernel
            x = self.intra_conv(x, prenorm=inter_ss, slope=self.slope)
            if ones_input:
                skip = self.norm(self.skip_conv(skip), kernel_stats=False)
            else:
                skip = self.norm(self.skip_conv.grouped(skip))
            return SphericalPointCloud(x.xyz, x.feats + self.act(skip),
                                       x.anchors)
        y, main_ss = self.intra_conv(x, prenorm=inter_ss, defer_norm_act=True,
                                     slope=self.slope)
        feats = so3conv.separable_tail(
            skip, self.skip_conv.weight_cd(), self.skip_conv.bias,
            self.norm.scale_shift(y.feats.shape[2]), y.feats, main_ss,
            self.slope)
        return SphericalPointCloud(y.xyz, feats, y.anchors)


class BasicSO3ConvBlock(nn.Module):
    """Sequencer over the layers of one backbone block: separable blocks,
    inter blocks (``inter`` / ``inter_block``) and intra blocks
    (``intra_block``), with the grouping cache of JAX ``nn/blocks.py:249-279``:
    consecutive stride-1 layers on the unfused path (``pooling``) share one
    grouping, reset after any strided layer. The fused inter conv makes no
    grouping to share (as the JAX package's fused path returns no
    ``inter_w``), so without pooling each layer groups its own."""

    def __init__(self, params: Sequence[Dict[str, Any]]):
        super().__init__()
        blocks, self.types, self.strides = [], [], []
        for prm in params:
            t = prm['type']
            if t == 'separable_block':
                blocks.append(SeparableSO3ConvBlock(prm['args']))
            elif t in ('inter', 'inter_block'):
                blocks.append(InterSO3ConvBlock(**prm['args']))
            elif t == 'intra_block':
                blocks.append(IntraSO3ConvBlock(**prm['args']))
            else:
                raise ValueError(f'No such type of SO3Conv {t}')
            self.types.append(t)
            self.strides.append(prm['args'].get('stride', 1))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: SphericalPointCloud,
                ones_input: bool = False) -> SphericalPointCloud:
        cache = so3conv.GroupingCache()
        for i, (t, blk) in enumerate(zip(self.types, self.blocks)):
            if t == 'intra_block':
                x = blk(x)
                continue
            x = blk(x, ones_input=ones_input and i == 0, cache=cache)
            if t != 'separable_block':
                x = x[1]
            if self.strides[i] > 1:
                cache.grouping = None
        return x


class PropagationBlock(nn.Module):
    """KernelPropagation + InstanceNorm + activation + dropout (JAX
    ``nn/blocks.py:281-298``; ``norm`` is accepted and unused, as there)."""

    def __init__(self, params: Dict[str, Any], norm=None,
                 activation: Optional[str] = 'relu',
                 dropout_rate: float = 0.0):
        super().__init__()
        self.prop = KernelPropagation(**params)
        self.norm = InstanceNorm()
        self.act = get_activation(activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, frag, clouds) -> SphericalPointCloud:
        x = self.prop(frag, clouds)
        return SphericalPointCloud(
            x.xyz, self.dropout(_activate(self.act, self.norm(x.feats))),
            x.anchors)
