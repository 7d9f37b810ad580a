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
(separable blocks, at one anchor without their intra conv, the inter blocks
of kanchor < 60 and ``intra_block`` layers), and for the heads and modules
no builder uses (``ClsOutBlockR``, ``InvOutBlockR``,
``InvOutBlockPointnet``: ``head_state``; ``KernelPropagation`` and
``PropagationBlock``: ``propagation_state``):

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
    if 'IntraSO3ConvBlock_0' in p:                   # none at one anchor
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


def intra_block_state(p, s=None,
                      base: str = '') -> 'OrderedDict[str, torch.Tensor]':
    """One JAX ``IntraSO3ConvBlock`` (an ``intra_block`` layer; its
    InstanceNorm has no parameters) -> the port's entries under ``base``."""
    pre = f'{base}.' if base else ''
    return OrderedDict([(f'{pre}conv.basic_conv.W',
                         _so3_w(p['IntraSO3Conv_0']['W']))])


BLOCKS = {'SeparableSO3ConvBlock_': separable_block_state,
          'InterSO3ConvBlock_': inter_block_state,
          'IntraSO3ConvBlock_': intra_block_state}
# a layer type of the block parameters -> its JAX module prefix
LAYER_PREFIX = {'separable_block': 'SeparableSO3ConvBlock_',
                'inter': 'InterSO3ConvBlock_',
                'inter_block': 'InterSO3ConvBlock_',
                'intra_block': 'IntraSO3ConvBlock_'}


def _layers(block, types):
    """[(JAX module name, port layer index)] of one BasicSO3ConvBlock's
    params ``block``: in the order of the layer ``types`` where given (the
    JAX package numbers each module type apart, so a block that mixes
    types needs them), else by each prefix's own numbering."""
    if types is None:
        return [(blk, int(blk.rsplit('_', 1)[1]))
                for prefix in BLOCKS for blk in _numbered(block, prefix)]
    seen, out = {}, []
    for j, t in enumerate(types):
        prefix = LAYER_PREFIX[t]
        out.append((f'{prefix}{seen.get(prefix, 0)}', j))
        seen[prefix] = seen.get(prefix, 0) + 1
    return out


def head_state(kind: str, hp, hs=None, params=None,
               base: str = 'outblock') -> 'OrderedDict[str, torch.Tensor]':
    """One JAX head's params ``hp`` and batch_stats ``hs`` -> the port
    head's entries under ``base``: ``kind`` 'ClsOutBlockR' (``params``, the
    head's parameters, tell its fc layers and whether it holds an attention
    layer), 'InvOutBlockR' or 'InvOutBlockPointnet'."""
    sd, pre = OrderedDict(), f'{base}.' if base else ''
    denses = _numbered(hp, 'Dense1x1_')
    if kind == 'InvOutBlockPointnet':
        _dense(sd, f'{pre}pointnet.embed',
               hp['PointnetSO3Conv_0']['Dense1x1_0'])
        if denses:
            _dense(sd, f'{pre}attention_layer', hp['Dense1x1_0'], 'conv1d')
        return sd
    if kind == 'InvOutBlockR':
        n_mlp = len(params['mlp']) if params else len(denses)
        for t in range(n_mlp):
            _dense(sd, f'{pre}linear.{t}', hp[f'Dense1x1_{t}'])
        if len(denses) > n_mlp:
            _dense(sd, f'{pre}attention_layer', hp[f'Dense1x1_{n_mlp}'],
                   'conv1d')
        return sd
    if kind != 'ClsOutBlockR':
        raise ValueError(f'head {kind} is not ported')
    n_mlp, n_intra = len(params['mlp']), len(params.get('intra', []))
    for t in range(n_mlp):
        _dense(sd, f'{pre}linear.{t}', hp[f'Dense1x1_{t}'])
        _bn(sd, f'{pre}norm.{t}', hp[f'BatchNorm_{t}'], hs[f'BatchNorm_{t}'])
    for j in range(n_intra):
        sd.update(intra_block_state(hp[f'IntraSO3ConvBlock_{j}'],
                                    base=f'{pre}intra.{j}'))
        _dense(sd, f'{pre}skipconnection.{j}', hp[f'Dense1x1_{n_mlp + j}'])
        _bn(sd, f'{pre}skip_norm.{j}', hp[f'BatchNorm_{n_mlp + j}'],
            hs[f'BatchNorm_{n_mlp + j}'])
    t = n_mlp + n_intra
    if len(denses) == t + len(params['fc']) + 2:       # attention pooling
        _dense(sd, f'{pre}attention_layer', hp[f'Dense1x1_{t}'], 'conv1d')
        t += 1
    for f in range(len(params['fc'])):
        _dense(sd, f'{pre}fc1.{f}', hp[f'Dense1x1_{t + f}'], 'linear')
    _dense(sd, f'{pre}fc2', hp[f'Dense1x1_{t + len(params["fc"])}'],
           'linear')
    return sd


def propagation_state(p, base: str = '') -> 'OrderedDict[str, torch.Tensor]':
    """A JAX ``KernelPropagation``'s params ``p`` (or a
    ``PropagationBlock``'s, which hold it as ``KernelPropagation_0``) ->
    the port's entries under ``base`` (``basic_conv.W``; a block's
    ``prop.basic_conv.W``)."""
    pre = f'{base}.' if base else ''
    if 'KernelPropagation_0' in p:
        return propagation_state(p['KernelPropagation_0'], f'{pre}prop')
    return OrderedDict([(f'{pre}basic_conv.W',
                         _so3_w(p['BasicSO3Conv_0']['W']))])


HEADS = ('ClsOutBlockR', 'InvOutBlockR', 'InvOutBlockPointnet')


def from_jax_variables(variables: Dict[str, Any],
                       model_params: Dict[str, Any] = None
                       ) -> 'OrderedDict[str, torch.Tensor]':
    """JAX cls_so3net_pn, inv_so3net_pn or reg_so3net variables -> the port's
    state_dict. Parameters are fp32 in both packages, so the same state_dict
    serves both compute dtypes. ``model_params``: the model's block
    parameters (the port model's ``params``), which a backbone block mixing
    layer types (``intra_block`` among others) and a ``ClsOutBlockR`` head
    need."""
    params, stats = variables['params'], variables.get('batch_stats', {})
    sd = OrderedDict()
    for top in _numbered(params, 'BasicSO3ConvBlock_'):
        i = int(top.rsplit('_', 1)[1])
        types = None if model_params is None else [
            layer['type'] for layer in model_params['backbone'][i]]
        seen = set()
        for blk, j in _layers(params[top], types):
            state = next(f for pre, f in BLOCKS.items()
                         if blk.startswith(pre))
            sd.update(state(params[top][blk],
                            stats.get(top, {}).get(blk, {}),
                            f'backbone.{i}.blocks.{j}'))
            seen.add(blk)
        extra = set(params[top]) - seen
        if extra:
            raise ValueError(f'{top}: blocks not ported: {sorted(extra)}')
    for kind in HEADS:
        if f'{kind}_0' in params:
            sd.update(head_state(kind, params[f'{kind}_0'],
                                 stats.get(f'{kind}_0', {}),
                                 (model_params or {}).get('outblock')))
            return sd
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
    if 'ClsOutBlockPointnet_0' not in params:            # a backbone alone
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
