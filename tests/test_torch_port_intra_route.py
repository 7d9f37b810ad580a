"""Which kernel the bf16 intra conv wrappers launch on the card, decided on
the CPU: every intra layer of both models' full-width builds (the bf16
forward and B6 df) goes to the tensor-core kernel (``mma_route``), fp32
and the shapes off its envelope to the SGEMM, and B6 df's workspace
follows the tensor-core kernel's blocks. The kernels themselves are
held against their plain versions on the card
(tests/test_torch_port_gpu.py); the plain versions against the JAX
package in tests/test_torch_port_bf16*.py.
"""

import pytest
import torch

from epn_pointcloud_tpu_torch import models, run_3dmatch
from epn_pointcloud_tpu_torch.app import config
from epn_pointcloud_tpu_torch.nn.layers import IntraSO3Conv
from epn_pointcloud_tpu_torch.ops import kernels as tkern

BF16 = torch.bfloat16


def _opt(name):
    opt = config.parse_args(['experiment', '-d', 'unused'])
    if name == 'inv_so3net_pn':
        return run_3dmatch.config_opt_3dmatch(opt)
    opt.model.model = name
    opt.model.flag = 'attention'
    return opt


def _intra_layers(name):
    """(na, K, c, d) of every intra conv of the full-width model."""
    model = models.build_model_from(_opt(name), seed=0)
    return [(m.trace_idx.shape[0], m.basic_conv.n_kernel,
             m.basic_conv.dim_in, m.basic_conv.dim_out)
            for m in model.modules() if isinstance(m, IntraSO3Conv)]


@pytest.mark.parametrize('name,n_layers', [('cls_so3net_pn', 7),
                                           ('inv_so3net_pn', 8)])
def test_every_model_intra_layer_takes_the_tensor_core_kernel(name,
                                                              n_layers):
    layers = _intra_layers(name)
    assert len(layers) == n_layers
    ik = tkern.intra_conv
    for na, K, c, d in layers:
        assert ik.mma_route(BF16, na, K, c, d), (na, K, c, d)
        assert not ik.mma_route(torch.float32, na, K, c, d)


@pytest.mark.parametrize('na,K,c,d', [(60, 12, 64, 96), (60, 12, 96, 96),
                                      (60, 12, 512, 512), (12, 12, 64, 64),
                                      (60, 6, 64, 64)])
def test_shapes_off_the_envelope_take_the_sgemm(na, K, c, d):
    """c != d, a width no model layer has, another group or kernel size."""
    assert not tkern.intra_conv.mma_route(BF16, na, K, c, d)


@pytest.mark.parametrize('d,points', [(32, 16), (64, 8), (96, 16),
                                      (128, 4), (256, 4)])
def test_block_points_follow_the_column_tile(d, points):
    """A tensor-core block owns 512 / BN whole points, BN the widest of
    128, 64, 32 that divides d: 30720 accumulators a block at every BN."""
    assert tkern.intra_conv.mma_block_points(d) == points
    bn = 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32
    assert points * 60 * bn == 30720


def test_reset_counts_clears_the_routes():
    tkern.intra_conv.routes['mma'] += 3
    tkern.inter_conv.routes['sgemm'] += 2
    tkern.reset_counts()
    assert set(tkern.intra_conv.routes.values()) == {0}
    assert set(tkern.inter_conv.routes.values()) == {0}
