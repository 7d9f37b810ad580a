"""Which kernel the bf16 inter backward scatter wrappers (the fused dTable
and the W-off dG) launch on the card, decided on the CPU: every such layer
of both models' full-width builds goes to the tensor-core kernel
(``bwd_mma_route``), fp32 and the shapes off its envelope to the template.
The kernels themselves are held against their plain versions on the card
(tests/test_torch_port_gpu.py); the plain versions against the JAX package
in tests/test_torch_port_bf16_train.py and tests/test_torch_port_inv_bf16.py.
"""

import pytest
import torch

from epn_pointcloud_tpu_torch import models
from epn_pointcloud_tpu_torch.nn.layers import InterSO3Conv
from epn_pointcloud_tpu_torch.ops import kernels as tkern

from test_torch_port_intra_route import _opt

BF16 = torch.bfloat16


def _scatter_layers(name):
    """(entry, K, c, d, nn, na) of every inter conv of the full-width model
    with a feature table (layer 0's ones input has no table gradient): the
    W-off dG where the backward composes, else the fused dTable."""
    model = models.build_model_from(_opt(name), seed=0)
    ic = tkern.inter_conv
    out = []
    for m in model.modules():
        if isinstance(m, InterSO3Conv) and m.basic_conv.dim_in > 1:
            c, nn = m.basic_conv.dim_in, m.n_neighbor
            entry = 'dg' if ic.composed_backward(c, nn) else 'dtable'
            out.append((entry, m.basic_conv.n_kernel, c,
                        m.basic_conv.dim_out, nn, m.anchors.shape[0]))
    return out


@pytest.mark.parametrize('name,n_dtable,n_dg', [('cls_so3net_pn', 6, 0),
                                                ('inv_so3net_pn', 3, 4)])
def test_every_model_scatter_layer_takes_the_tensor_core_kernel(name,
                                                                n_dtable,
                                                                n_dg):
    layers = _scatter_layers(name)
    entries = [e for e, *_ in layers]
    assert (entries.count('dtable'), entries.count('dg')) == (n_dtable, n_dg)
    ic = tkern.inter_conv
    for entry, K, c, d, nn, na in layers:
        dd = d if entry == 'dtable' else None
        assert ic.bwd_mma_route(BF16, K, c, nn, na, dd), (entry, c, d, nn)
        assert not ic.bwd_mma_route(torch.float32, K, c, nn, na, dd)


@pytest.mark.parametrize('K,c,nn,na,d', [(24, 40, 16, 60, 64),
                                         (24, 8, 32, 60, None),
                                         (24, 64, 65, 60, 64),
                                         (24, 64, 16, 12, 64),
                                         (18, 64, 16, 60, None),
                                         (24, 64, 16, 60, 48)])
def test_shapes_off_the_envelope_take_the_template(K, c, nn, na, d):
    """Channels not a multiple of 16, more than 64 neighbors, another
    group, another kernel size, a fused d not a multiple of 32."""
    assert not tkern.inter_conv.bwd_mma_route(BF16, K, c, nn, na, d)


def test_reset_counts_clears_the_scatter_routes():
    ic = tkern.inter_conv
    ic.routes['dtable_mma'] += 2
    ic.routes['dg'] += 1
    tkern.reset_counts()
    assert set(ic.routes.values()) == {0}
    assert {'dtable_mma', 'dtable', 'dg_mma', 'dg'} <= set(ic.routes)
