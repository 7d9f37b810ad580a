"""ModelNet40 classification model (counterpart of
``epn_pointcloud_tpu/models/cls_so3net_pn.py``).

The builder copies the block-parameter derivation verbatim: num_centers =
input_num / 2^i, radius_ratio = initial_radius_ratio * mult^sampling_density,
sigma doubling per stride, neighbor = int(sampling_ratio * nc *
rr^(1/sampling_density)) with the x2 at strided layers, including the int()
truncations.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..nn.blocks import BasicSO3ConvBlock
from ..nn.heads import ClsOutBlockPointnet
from ..nn.layers import init_parameters
from ..ops import so3conv


class ClsSO3ConvModel(nn.Module):
    """Backbone blocks + ClsOutBlockPointnet. x [b, p, 3] -> (logits [b, 40],
    attention logits [b, na])."""

    def __init__(self, params: Dict[str, Any], seed: Optional[int] = 0):
        super().__init__()
        self.params = params
        self.backbone = nn.ModuleList(BasicSO3ConvBlock(bp)
                                      for bp in params['backbone'])
        self.outblock = ClsOutBlockPointnet(params['outblock'])
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, rlabel=None):
        """rlabel: the rotation label of ``--debug-mode knownatt``, which
        the head ignores (as the JAX model's does)."""
        x = so3conv.preprocess_input(x, self.params['na'])
        for bi, block in enumerate(self.backbone):
            # occupancy-ones input: block 0's first layer skips the gather
            x = block(x, ones_input=bi == 0)
        return self.outblock(x)


def build_model(opt,
                mlps=((64, 64), (128, 128), (256, 256), (256,)),
                out_mlps=(256,),
                strides=(2, 2, 2, 2),
                initial_radius_ratio=0.2,
                sampling_ratio=0.4,
                sampling_density=0.5,
                kernel_density=1,
                kernel_multiplier=2,
                input_radius=1.0,
                sigma_ratio=0.5,
                xyz_pooling=None,
                so3_pooling='max',
                seed: Optional[int] = 0,
                to_file: Optional[str] = None):
    """Derive the block-parameter tree and build the model (seeded init);
    the tree is written to ``to_file`` as JSON when one is given."""
    strides = list(strides)
    input_num = opt.model.input_num
    dropout_rate = opt.model.dropout_rate
    temperature = opt.train_loss.temperature
    so3_pooling = opt.model.flag
    na = 1 if opt.model.kpconv else opt.model.kanchor

    if input_num > 1024:
        sampling_ratio /= (input_num / 1024)
        strides[0] = int(2 * (input_num / 1024))

    params = {'name': 'Invariant SO3Conv Model', 'backbone': [], 'na': na}
    dim_in = 1

    n_layer = len(mlps)
    stride_current = 1
    stride_multipliers = [stride_current]
    for i in range(n_layer):
        stride_current *= 2
        stride_multipliers.append(stride_current)

    num_centers = [int(input_num / m) for m in stride_multipliers]
    radius_ratio = [initial_radius_ratio * m ** sampling_density
                    for m in stride_multipliers]
    radii = [r * input_radius for r in radius_ratio]
    weighted_sigma = [sigma_ratio * radii[0] ** 2]
    for idx, s in enumerate(strides):
        weighted_sigma.append(weighted_sigma[idx] * 2)

    for i, block in enumerate(mlps):
        block_param = []
        for j, dim_out in enumerate(block):
            lazy_sample = i != 0 or j != 0
            stride_conv = i == 0 or xyz_pooling != 'stride'
            neighbor = int(sampling_ratio * num_centers[i]
                           * radius_ratio[i] ** (1 / sampling_density))
            kernel_size = 1
            if j == 0:
                inter_stride = strides[i]
                nidx = i if i == 0 else i + 1
                if stride_conv:
                    neighbor *= 2
            else:
                inter_stride = 1
                nidx = i + 1

            block_type = 'inter_block' if na < 60 else 'separable_block'
            block_param.append({
                'type': block_type,
                'args': {
                    'dim_in': dim_in,
                    'dim_out': dim_out,
                    'kernel_size': kernel_size,
                    'stride': inter_stride,
                    'radius': radii[nidx],
                    'sigma': weighted_sigma[nidx],
                    'n_neighbor': neighbor,
                    'lazy_sample': lazy_sample,
                    'dropout_rate': dropout_rate,
                    'multiplier': kernel_multiplier,
                    'activation': 'leaky_relu',
                    'pooling': xyz_pooling,
                    'kanchor': na,
                    'norm': 'BatchNorm2d',
                },
            })
            dim_in = dim_out
        params['backbone'].append(block_param)

    params['outblock'] = {
        'dim_in': dim_in,
        'mlp': list(out_mlps),
        'fc': [64],
        'k': 40,
        'pooling': so3_pooling,
        'temperature': temperature,
        'kanchor': na,
    }
    if to_file is not None:
        with open(to_file, 'w') as f:
            json.dump(params, f)

    return ClsSO3ConvModel(params, seed=seed)

