"""Weights into the port: from the JAX package's variable tree, and from an
original-EPN checkpoint.

``load_reference_state_dict`` loads a state_dict of the original EPN into
a port model: the port's module tree already has the original names and
layouts, so it is a strict key and shape check (the original's constant
buffers, ``anchors``, ``kernels``, ``intra_idx`` and
``num_batches_tracked``, are skipped as ``epn_pointcloud_tpu/compat.py``
skips them). Such weights compute the function they were trained for only
under ``icosahedron.set_convention('reference')``.

``from_jax_variables`` inverts the layout mappings of
``epn_pointcloud_tpu/compat.py`` for the cls, the inv and the reg model
(separable blocks, and the inter blocks of kanchor < 60):

  * SO(3) conv ``W``  flax [k, c, d]     -> [d, c*k] (c-major, k-minor)
  * Dense1x1 kernel   flax [c, d]        -> Conv2d [d, c, 1, 1], Conv1d
                                            [d, c, 1] or Linear [d, c]
  * BatchNorm         scale/bias + batch_stats mean/var
                                         -> weight/bias/running_mean/running_var

The input is ``{'params': ..., 'batch_stats': ...}`` as nested dicts of
numpy arrays (e.g. the JAX model's variables after ``np.asarray``); the inv
and the reg model, whose norms are InstanceNorms, have no BatchNorm and may
have no ``batch_stats``.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order='C'))


def _so3_w(w) -> torch.Tensor:
    """flax [k, c, d] -> [d, c*k]."""
    w = np.asarray(w)
    k, c, d = w.shape
    return _t(np.transpose(w, (2, 1, 0)).reshape(d, c * k))


def _dense(sd, base, p, kind='conv2d'):
    w = np.asarray(p['kernel']).T                       # [d, c]
    shape = {'conv2d': w.shape + (1, 1), 'conv1d': w.shape + (1,),
             'linear': w.shape}[kind]
    sd[f'{base}.weight'] = _t(w.reshape(shape))
    if 'bias' in p:
        sd[f'{base}.bias'] = _t(p['bias'])


def _bn(sd, base, p, s):
    sd[f'{base}.weight'] = _t(p['scale'])
    sd[f'{base}.bias'] = _t(p['bias'])
    sd[f'{base}.running_mean'] = _t(s['mean'])
    sd[f'{base}.running_var'] = _t(s['var'])


def _numbered(tree, prefix):
    return sorted((k for k in tree if k.startswith(prefix)),
                  key=lambda k: int(k.rsplit('_', 1)[1]))


def separable_block_state(p, s, base: str = '') -> 'OrderedDict[str, torch.Tensor]':
    """One JAX ``SeparableSO3ConvBlock``'s params ``p`` and batch_stats ``s``
    -> the port's ``SeparableSO3ConvBlock`` state_dict entries, under the
    key prefix ``base``."""
    pre = f'{base}.' if base else ''
    sd = OrderedDict()
    inter_p = p['InterSO3ConvBlock_0']
    sd[f'{pre}inter_conv.conv.basic_conv.W'] = _so3_w(
        inter_p['InterSO3Conv_0']['W'])
    if 'BatchNorm_0' in inter_p:
        _bn(sd, f'{pre}inter_conv.norm', inter_p['BatchNorm_0'],
            s['InterSO3ConvBlock_0']['BatchNorm_0'])
    sd[f'{pre}intra_conv.conv.basic_conv.W'] = _so3_w(
        p['IntraSO3ConvBlock_0']['IntraSO3Conv_0']['W'])
    _dense(sd, f'{pre}skip_conv', p['Dense1x1_0'])
    if 'BatchNorm_0' in p:
        _bn(sd, f'{pre}norm', p['BatchNorm_0'], s['BatchNorm_0'])
    return sd


def inter_block_state(p, s, base: str = '') -> 'OrderedDict[str, torch.Tensor]':
    """One JAX ``InterSO3ConvBlock`` (an ``inter_block`` layer, kanchor <
    60)'s params ``p`` and batch_stats ``s`` -> the port's
    ``InterSO3ConvBlock`` state_dict entries, under the key prefix
    ``base``."""
    pre = f'{base}.' if base else ''
    sd = OrderedDict()
    sd[f'{pre}conv.basic_conv.W'] = _so3_w(p['InterSO3Conv_0']['W'])
    if 'BatchNorm_0' in p:
        _bn(sd, f'{pre}norm', p['BatchNorm_0'], s['BatchNorm_0'])
    return sd


BLOCKS = {'SeparableSO3ConvBlock_': separable_block_state,
          'InterSO3ConvBlock_': inter_block_state}


def from_jax_variables(variables: Dict[str, Any]) -> 'OrderedDict[str, torch.Tensor]':
    """JAX cls_so3net_pn, inv_so3net_pn or reg_so3net variables -> the port's
    state_dict. Parameters are fp32 in both packages, so the same state_dict
    serves both compute dtypes."""
    params, stats = variables['params'], variables.get('batch_stats', {})
    sd = OrderedDict()
    for top in _numbered(params, 'BasicSO3ConvBlock_'):
        i = int(top.rsplit('_', 1)[1])
        seen = set()
        for prefix, state in BLOCKS.items():
            for blk in _numbered(params[top], prefix):
                j = int(blk.rsplit('_', 1)[1])
                sd.update(state(params[top][blk],
                                stats.get(top, {}).get(blk, {}),
                                f'backbone.{i}.blocks.{j}'))
                seen.add(blk)
        extra = set(params[top]) - seen
        if extra:
            raise ValueError(f'{top}: blocks not ported: {sorted(extra)}')

    if 'InvOutBlockMVD_0' in params:
        hp = params['InvOutBlockMVD_0']
        _dense(sd, 'outblock.attention_layer.0', hp['Dense1x1_0'])
        _dense(sd, 'outblock.attention_layer.2', hp['Dense1x1_1'])
        _dense(sd, 'outblock.pointnet.embed',
               hp['PointnetSO3Conv_0']['Dense1x1_0'])
        return sd
    if 'RelSO3OutBlockR_0' in params:
        hp = params['RelSO3OutBlockR_0']
        _dense(sd, 'outblock.pointnet.embed',
               hp['PointnetSO3Conv_0']['Dense1x1_0'])
        n_mlp = len(_numbered(hp, 'Dense1x1_')) - 2
        for t in range(n_mlp):
            _dense(sd, f'outblock.linear.{t}', hp[f'Dense1x1_{t}'])
        _dense(sd, 'outblock.attention_layer', hp[f'Dense1x1_{n_mlp}'])
        _dense(sd, 'outblock.regressor_layer', hp[f'Dense1x1_{n_mlp + 1}'])
        return sd
    hp, hs = params['ClsOutBlockPointnet_0'], stats['ClsOutBlockPointnet_0']
    norms = _numbered(hp, 'BatchNorm_')
    denses = _numbered(hp, 'Dense1x1_')
    n_mlp = len(norms) - 1
    for t in range(n_mlp):
        _dense(sd, f'outblock.linear.{t}', hp[f'Dense1x1_{t}'])
        _bn(sd, f'outblock.norm.{t}', hp[f'BatchNorm_{t}'],
            hs[f'BatchNorm_{t}'])
    _dense(sd, 'outblock.pointnet.embed', hp['PointnetSO3Conv_0']['Dense1x1_0'])
    _bn(sd, f'outblock.norm.{n_mlp}', hp[f'BatchNorm_{n_mlp}'],
        hs[f'BatchNorm_{n_mlp}'])
    t = n_mlp
    if len(denses) == n_mlp + 2:                       # attention pooling
        _dense(sd, 'outblock.attention_layer', hp[f'Dense1x1_{t}'], 'conv1d')
        t += 1
    _dense(sd, 'outblock.fc2', hp[f'Dense1x1_{t}'], 'linear')
    return sd


# the original EPN's constant buffers: not weights (JAX compat._Importer)
_REFERENCE_CONSTANTS = re.compile(
    r'\.(anchors|kernels|intra_idx|num_batches_tracked)$')


def load_reference_state_dict(model: torch.nn.Module, state_dict) -> None:
    """Load an original-EPN state_dict (torch tensors or numpy arrays) into
    ``model`` strictly: every key of the model's state_dict present with
    its shape, and no other key but the original's constant buffers.
    Raises ValueError naming the missing, unexpected and mis-shaped keys.
    Values are cast to the model's types."""
    own = model.state_dict()
    sd = {k: v for k, v in state_dict.items()
          if not _REFERENCE_CONSTANTS.search(k)}
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = sorted(f'{k}: {tuple(sd[k].shape)} for {tuple(own[k].shape)}'
                    for k in set(own) & set(sd)
                    if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(f'reference state_dict does not fit the model: '
                         f'missing {missing}, unexpected {unexpected}, '
                         f'shapes {shapes}')
    model.load_state_dict(OrderedDict(
        (k, torch.as_tensor(v).to(own[k].dtype)) for k, v in sd.items()))
