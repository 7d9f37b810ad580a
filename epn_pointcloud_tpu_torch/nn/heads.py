"""Output heads (counterpart of ``epn_pointcloud_tpu/nn/heads.py``).

Classification head ``ClsOutBlockPointnet`` (``heads.py:81-142``): 1x1
convs + BatchNorm + ReLU ->
PointnetSO3Conv -> BatchNorm + ReLU -> pooling over the anchors ('max',
'mean', 'debug': anchor 0, or 'attention*': a softmax of attention logits)
-> linear. In the bf16 production mode at more than one anchor (the JAX
package's packed layout) the mlp convs run the anchor-grouped 1x1 conv
kernel (``GroupedConvFn``, with its backward) and their BatchNorm + ReLU
round to bf16, the BatchNorm in train mode on one-pass statistics from the
moments kernel (``heads.py:101-110``); at one anchor (kpconv) they are the
unpacked 1x1 convs and plain-torch statistics (``heads.py:111-115``). The
pointnet, attention and logits are fp32 in both modes (``heads.py:101-142``
of the JAX package).

3DMatch descriptor head ``InvOutBlockMVD`` (``heads.py:214-241``): anchor
attention, the attention-weighted anchor sum, a single-anchor PointNet and
an L2 normalization. In bf16 it keeps the JAX package's types: the
attention's 1x1 convs, its softmax and the weighted sum in bf16 (fp32
accumulation in the convs), then the PointNet, whose concat with the fp32
coordinates promotes to fp32, and the normalization in fp32.

Rotation regression heads: ``RelSO3OutBlockR`` (``heads.py:265-307``), the
rotation-alignment pair head (a shared PointnetSO3Conv over each cloud, the
60 x 60 anchor pairs' concatenated features through 1x1 convs + ReLU, the
pair attention and the regressed rotations), and ``SO3OutBlockR``
(``heads.py:244-262``), its single-cloud form. Their products are plain
matmuls outside any TPU kernel in the JAX package. In bf16 the pair head is
fp32 after its PointNet (whose concat with the fp32 coordinates promotes
the bf16 features), as in the JAX package; ``SO3OutBlockR``'s 1x1 convs
run in the features' type.

The heads no builder uses: ``ClsOutBlockR`` (``heads.py:25-78``: 1x1
convs + BatchNorm + ReLU, the mean over the points, intra conv blocks at
60 anchors with 1x1-conv skips on that one-point field, the anchor pooling
-- mean, debug, max, the ground-truth label's one-hot, or attention* --
and fc layers), ``InvOutBlockR`` (``heads.py:145-180``: 1x1 convs with
InstanceNorm + ReLU between them, the anchor pooling, L2 normalization)
and ``InvOutBlockPointnet`` (``heads.py:183-211``: PointnetSO3Conv, the
anchor pooling, L2 normalization of the descriptor and of the per-anchor
field). Each raises for a pooling mode the JAX head does not take, at its
call as there.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops import so3conv
from ..ops.so3conv import SphericalPointCloud
from .blocks import IntraSO3ConvBlock
from .layers import BatchNorm, Dense1x1, InstanceNorm, PointnetSO3Conv


POOLINGS = ('max', 'mean', 'debug')


class ClsOutBlockPointnet(nn.Module):
    """SphericalPointCloud -> (logits [b, k], attention logits [b, a]);
    without attention pooling the second output is the mlp's field [b, p,
    a, c] squeezed, as the JAX head returns it."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        p = params
        self.pooling = p.get('pooling', 'max')
        self.attention = self.pooling.startswith('attention')
        if not self.attention and self.pooling not in POOLINGS:
            raise NotImplementedError(f'Pooling mode {self.pooling}')
        self.temperature = p['temperature']
        c_in = p['dim_in']
        self.linear = nn.ModuleList()
        self.norm = nn.ModuleList()
        for c in p['mlp']:
            self.linear.append(Dense1x1(c_in, c))
            self.norm.append(BatchNorm(c))
            c_in = c
        self.pointnet = PointnetSO3Conv(c_in, c_in, p['kanchor'])
        self.norm.append(BatchNorm(c_in))
        if self.attention:
            self.attention_layer = Dense1x1(c_in, 1, kind='conv1d')
        self.fc2 = Dense1x1(c_in, p['k'], kind='linear')

    def forward(self, x: SphericalPointCloud):
        x_out = x.feats
        grouped = so3conv.packed_enabled() and x_out.shape[2] > 1
        for lin, bn in zip(self.linear, self.norm):
            x_out = torch.relu(bn(lin.grouped(x_out) if grouped
                                  else lin(x_out), kernel_stats=grouped))
        field = x_out
        x_out = self.pointnet(SphericalPointCloud(x.xyz, x_out, x.anchors))
        x_out = torch.relu(self.norm[-1](x_out))               # [b, a, c]
        if not self.attention:
            pooled = (x_out.mean(dim=1) if self.pooling == 'mean' else
                      x_out[:, 0] if self.pooling == 'debug' else
                      x_out.max(dim=1).values)
            return self.fc2(pooled), field.squeeze()
        att = self.attention_layer(x_out)                      # [b, a, 1]
        conf = torch.softmax(att * self.temperature, dim=1)
        logits = self.fc2((x_out * conf).sum(dim=1))
        return logits, att.squeeze(-1)


class InvOutBlockMVD(nn.Module):
    """SphericalPointCloud -> (descriptor [b, c_out] of unit length,
    attention [b, p, a, c]): Dense1x1 -> ReLU -> Dense1x1 scores, softmax
    over the anchors, the weighted anchor sum [b, p, 1, c], PointnetSO3Conv
    on that one anchor, and an L2 normalization with a 1e-12 floor."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        c_in, c_out = params['dim_in'], params['mlp'][-1]
        self.attention_layer = nn.Sequential(
            Dense1x1(c_in, c_in), nn.ReLU(), Dense1x1(c_in, c_in))
        self.pointnet = PointnetSO3Conv(c_in, c_out, params['kanchor'])

    def forward(self, x: SphericalPointCloud):
        attn = torch.softmax(self.attention_layer(x.feats), dim=2)
        x_out = (x.feats * attn).sum(dim=2, keepdim=True)     # [b, p, 1, c]
        x_out = self.pointnet(SphericalPointCloud(x.xyz, x_out, None))
        x_out = x_out.reshape(x_out.shape[0], -1)
        return (x_out / x_out.norm(dim=1, keepdim=True).clamp(min=1e-12),
                attn)


class SO3OutBlockR(nn.Module):
    """Single-cloud rotation regression: feats [b, p, a, c] -> (confidence
    [b, a] (softmax over the anchors), y [b, a, nr]): 1x1 convs + ReLU, the
    mean over the points, an attention and a regressor 1x1 conv."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.temperature = params['temperature']
        nr = 4 if params.get('representation', 'quat') == 'quat' else 6
        c_in = params['dim_in']
        self.linear = nn.ModuleList()
        for c in params['mlp']:
            self.linear.append(Dense1x1(c_in, c))
            c_in = c
        self.attention_layer = Dense1x1(c_in, 1)
        self.regressor_layer = Dense1x1(c_in, nr)

    def forward(self, feats: torch.Tensor):
        x = feats
        for lin in self.linear:
            x = torch.relu(lin(x))
        x = x.mean(dim=1)                                       # [b, a, c]
        att = self.attention_layer(x).squeeze(-1)
        return (torch.softmax(att * self.temperature, dim=1),
                self.regressor_layer(x))


class RelSO3OutBlockR(nn.Module):
    """Relative rotation of a pair: (f1, f2 [b, p, a, c], x1, x2 [b, p, 3])
    -> (confidence [b, na_tgt, na_src] (softmax over na_tgt), y [b, na_tgt,
    na_src, nr]). One PointnetSO3Conv + ReLU serves both clouds; pair (i, j)
    is the concatenation of the source's anchor j and the target's anchor
    i."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        c_in, na = params['dim_in'], params['kanchor']
        rp = params['representation']
        if rp not in ('quat', 'ortho6d'):
            raise KeyError(f'Unrecognized representation of rotation: {rp}')
        nr = 4 if rp == 'quat' else 6
        self.temperature = params['temperature']
        self.pointnet = PointnetSO3Conv(c_in, c_in, na)
        c_in *= 2
        self.linear = nn.ModuleList()
        for c in params['mlp']:
            self.linear.append(Dense1x1(c_in, c))
            c_in = c
        self.attention_layer = Dense1x1(c_in, 1)
        self.regressor_layer = Dense1x1(c_in, nr)

    def forward(self, f1, f2, x1, x2):
        f1 = torch.relu(self.pointnet(SphericalPointCloud(x1, f1, None)))
        f2 = torch.relu(self.pointnet(SphericalPointCloud(x2, f2, None)))
        nb, na, c = f1.shape
        x_out = torch.cat([f1[:, None].expand(nb, na, na, c),
                           f2[:, :, None].expand(nb, na, na, c)], dim=-1)
        for lin in self.linear:
            x_out = torch.relu(lin(x_out))
        att = self.attention_layer(x_out).squeeze(-1)           # [b, na, na]
        return (torch.softmax(att * self.temperature, dim=1),
                self.regressor_layer(x_out))


def _l2n(v: torch.Tensor, dim: int) -> torch.Tensor:
    return v / v.norm(dim=dim, keepdim=True).clamp(min=1e-12)


class ClsOutBlockR(nn.Module):
    """Legacy classification head: feats [b, p, a, c] (, label [b] the
    rotation label of the ground-truth attention branch) -> (logits [b, k],
    the mlp's field squeezed, or the attention logits).

    Modules: ``linear.{t}`` / ``norm.{t}`` (the mlp's 1x1 convs and
    BatchNorms), ``intra.{j}`` (IntraSO3ConvBlock, ReLU by default),
    ``skipconnection.{j}`` / ``skip_norm.{j}`` (each intra's 1x1-conv skip
    and its BatchNorm), ``attention_layer`` (attention pooling: 1 logit an
    anchor for 'attention', one a channel for the other attention modes),
    ``fc1.{t}`` and ``fc2``."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        p = params
        self.pooling = p.get('pooling', 'max')
        self.temperature = p.get('temperature')
        self.kanchor = p.get('kanchor', 1)
        c_in = p['dim_in']
        self.linear, self.norm = nn.ModuleList(), nn.ModuleList()
        for c in p['mlp']:
            self.linear.append(Dense1x1(c_in, c))
            self.norm.append(BatchNorm(c))
            c_in = c
        self.intra = nn.ModuleList()
        self.skipconnection = nn.ModuleList()
        self.skip_norm = nn.ModuleList()
        for ip in p.get('intra', []):
            args = ip['args']
            self.intra.append(IntraSO3ConvBlock(**args))
            self.skipconnection.append(Dense1x1(c_in, args['dim_out']))
            self.skip_norm.append(BatchNorm(args['dim_out']))
            c_in = args['dim_out']
        if self.pooling.startswith('attention'):
            self.attention_layer = Dense1x1(
                c_in, 1 if self.pooling == 'attention' else c_in, 'conv1d')
        self.fc1 = nn.ModuleList()
        for c in p['fc']:
            self.fc1.append(Dense1x1(c_in, c, 'linear'))
            c_in = c
        self.fc2 = Dense1x1(c_in, p['k'], 'linear')

    def forward(self, feats: torch.Tensor, label=None):
        x = so3conv.unpack_feats(feats, self.kanchor)
        for lin, bn in zip(self.linear, self.norm):
            x = torch.relu(bn(lin(x), kernel_stats=False))
        out_feat = x
        x = x.mean(dim=1, keepdim=True)              # [b, 1, a, c]
        for intra, skip_lin, skip_bn in zip(self.intra, self.skipconnection,
                                            self.skip_norm):
            x_sp = intra(SphericalPointCloud(None, x, None))
            skip = torch.relu(skip_bn(skip_lin(x), kernel_stats=False))
            x = x_sp.feats + skip
        if self.pooling == 'mean':
            x = x.mean(dim=2).mean(dim=1)
        elif self.pooling == 'debug':
            x = x[:, :, 0].mean(dim=1)
        elif self.pooling == 'max':
            x = x.mean(dim=1).max(dim=1).values
        elif label is not None:
            # the ground-truth attention branch: the label's anchor
            x = x.mean(dim=1)                        # [b, a, c]
            label = label.reshape(label.shape[0], -1).squeeze()
            conf = torch.nn.functional.one_hot(
                label.long(), x.shape[1]).to(torch.float32)
            x = (x * conf[..., None]).sum(dim=1)
        elif self.pooling.startswith('attention'):
            x = x.mean(dim=1)                        # [b, a, c]
            att = self.attention_layer(x)            # [b, a, 1 or c]
            out_feat = att
            conf = torch.softmax(att * self.temperature, dim=1)
            x = (x * conf).sum(dim=1)
        else:
            raise NotImplementedError(f'Pooling mode {self.pooling}')
        for fc in self.fc1:
            x = torch.relu(fc(x))
        return self.fc2(x), out_feat.squeeze()


class InvOutBlockR(nn.Module):
    """Invariant descriptor head, conv form: feats [b, p, a, c] ->
    (descriptor [b, c_out] of unit length, the per-anchor field [b, a, c],
    or the attention's softmax [b, a]). Modules ``linear.{t}`` (1x1 convs;
    InstanceNorm + ReLU between them) and ``attention_layer``."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        p = params
        self.pooling = p.get('pooling', 'max')
        self.temperature = p.get('temperature')
        self.kanchor = p.get('kanchor', 1)
        c_in = p['dim_in']
        self.linear = nn.ModuleList()
        for c in p['mlp']:
            self.linear.append(Dense1x1(c_in, c))
            c_in = c
        self.norm = InstanceNorm()
        if self.pooling == 'attention':
            self.attention_layer = Dense1x1(c_in, 1, 'conv1d')

    def forward(self, feats: torch.Tensor):
        x = so3conv.unpack_feats(feats, self.kanchor)
        for i, lin in enumerate(self.linear):
            x = lin(x)
            if i != len(self.linear) - 1:
                x = torch.relu(self.norm(x))
        out_feat = x.mean(dim=1)                     # [b, a, c]
        if self.pooling == 'mean':
            x = x.mean(dim=2).mean(dim=1)
        elif self.pooling == 'debug':
            x = x[:, :, 0].mean(dim=1)
        elif self.pooling == 'max':
            x = x.mean(dim=1).max(dim=1).values
        elif self.pooling == 'attention':
            x = x.mean(dim=1)
            att = self.attention_layer(x)            # [b, a, 1]
            conf = torch.softmax(att * self.temperature, dim=1)
            x = (x * conf).sum(dim=1)
            out_feat = conf.squeeze(-1)
        else:
            raise NotImplementedError(f'Pooling mode {self.pooling}')
        return _l2n(x, 1), out_feat


class InvOutBlockPointnet(nn.Module):
    """Invariant descriptor head, PointNet form: SphericalPointCloud ->
    (descriptor [b, c_out] of unit length, the per-anchor field [b, a,
    c_out] L2-normalized over its channels). Modules ``pointnet`` and
    ``attention_layer``."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        p = params
        self.pooling = p.get('pooling', 'max')
        self.temperature = p.get('temperature')
        self.kanchor = p['kanchor']
        c_out = p['mlp'][-1]
        self.pointnet = PointnetSO3Conv(p['dim_in'], c_out, self.kanchor)
        if self.pooling == 'attention':
            self.attention_layer = Dense1x1(c_out, 1, 'conv1d')

    def forward(self, x: SphericalPointCloud):
        x = SphericalPointCloud(x.xyz, so3conv.unpack_feats(x.feats,
                                                            self.kanchor),
                                x.anchors)
        x_out = self.pointnet(x)                     # [b, a, c]
        out_feat = x_out
        if self.pooling == 'mean':
            x_out = x_out.mean(dim=1)
        elif self.pooling == 'max':
            x_out = x_out.max(dim=1).values
        elif self.pooling == 'attention':
            att = self.attention_layer(x_out)
            conf = torch.softmax(att * self.temperature, dim=1)
            x_out = (x_out * conf).sum(dim=1)
        else:
            raise NotImplementedError(f'Pooling mode {self.pooling}')
        return _l2n(x_out, 1), _l2n(out_feat, -1)
