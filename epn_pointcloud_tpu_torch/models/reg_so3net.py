"""Relative-rotation regression model (counterpart of
``epn_pointcloud_tpu/models/reg_so3net.py``).

The input is a pair of clouds [nb, 2, p, 3]; the pair is concatenated on
the batch axis ([2 * nb, p, 3], sources first), runs through one backbone,
is split back and goes to ``RelSO3OutBlockR``. The builder copies the
block-parameter derivation verbatim (``reg_so3net.py:51-149`` of the JAX
package): sigma doubles every level, a strided layer's neighbor count is
recomputed as 2 * int(...), the input radius is 1, and no norm is named, so
every block normalizes with InstanceNorm.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..nn.blocks import BasicSO3ConvBlock
from ..nn.heads import RelSO3OutBlockR
from ..nn.layers import init_parameters
from ..ops import icosahedron, so3conv


class RegSO3ConvModel(nn.Module):
    """Backbone blocks + RelSO3OutBlockR. x [nb, 2, p, 3] -> (confidence
    [nb, na, na], y [nb, na, na, nr])."""

    def __init__(self, params: Dict[str, Any], seed: Optional[int] = 0):
        super().__init__()
        self.params = params
        self.backbone = nn.ModuleList(BasicSO3ConvBlock(bp)
                                      for bp in params['backbone'])
        self.outblock = RelSO3OutBlockR(params['outblock'])
        if seed is not None:
            init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor):
        x = torch.cat([x[:, 0], x[:, 1]], dim=0)
        x = so3conv.preprocess_input(x, self.params['na'])
        for bi, block in enumerate(self.backbone):
            # occupancy-ones input: block 0's first layer skips the gather
            x = block(x, ones_input=bi == 0)
        nb = x.feats.shape[0] // 2
        return self.outblock(x.feats[:nb], x.feats[nb:], x.xyz[:nb],
                             x.xyz[nb:])

    def get_anchor(self) -> torch.Tensor:
        return torch.from_numpy(icosahedron.get_anchors())


def build_model(opt,
                mlps=((32, 32), (64, 64), (128, 128), (256,)),
                out_mlps=(256, 128, 64),
                strides=(2, 2, 2, 2),
                initial_radius_ratio=0.2,
                sampling_ratio=0.8,
                sampling_density=0.5,
                kernel_density=1,
                kernel_multiplier=2,
                input_radius=1.0,
                sigma_ratio=0.5,
                xyz_pooling=None,
                seed: Optional[int] = 0,
                to_file: Optional[str] = None):
    """Derive the block-parameter tree and build the model (seeded init);
    the tree is written to ``to_file`` as JSON when one is given."""
    strides = list(strides)
    input_num = opt.model.input_num
    dropout_rate = opt.model.dropout_rate
    temperature = opt.train_loss.temperature
    representation = opt.model.representation
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
                    neighbor = 2 * int(sampling_ratio * num_centers[i]
                                       * radius_ratio[i]
                                       ** (1 / sampling_density))
                    kernel_size = 1
            else:
                inter_stride = 1
                nidx = i + 1

            block_type = 'inter_block' if na != 60 else 'separable_block'
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
                },
            })
            dim_in = dim_out
        params['backbone'].append(block_param)

    params['outblock'] = {
        'dim_in': dim_in,
        'mlp': list(out_mlps),
        'fc': [64],
        'k': 40,
        'kanchor': na,
        'representation': representation,
        'temperature': temperature,
    }

    if to_file is not None:
        with open(to_file, 'w') as f:
            json.dump(params, f)

    return RegSO3ConvModel(params, seed=seed)
