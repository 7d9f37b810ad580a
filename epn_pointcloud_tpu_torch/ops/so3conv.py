"""SO(3)-anchor convolution functional core (counterpart of
``epn_pointcloud_tpu/ops/so3conv.py``) and the compute-precision policy.

Layout: xyz [b, p, 3]; feats [b, p, a, c]. A contiguous [b, p, 60, c]
tensor is the JAX package's packed [b, p, 60*c] layout in memory, so the
bf16 mode takes the packed path's numerics with no layout switch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import icosahedron, kernels, sampling
from .kernels import build as _build
from .kernels import grouped_conv as _gc
from .kernels import inter_conv as _ic
from .kernels import intra_conv as _intra
from .kernels import moments as _mom
from .kernels import ones_conv as _ones

# Compute precision of the conv path (``set_compute_dtype``). fp32 is the
# parity mode; bf16 is the production mode: activations and conv / 1x1
# weights are bf16 at use (parameters stay fp32 in the modules), every
# product accumulates in fp32, and norm statistics, scale/shift folds and
# the head's attention and logits are fp32.
_DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}
_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(name: str) -> None:
    """Set the process-wide compute dtype ('fp32' or 'bf16'), as the JAX
    package's trainer does at start-up."""
    global _COMPUTE_DTYPE
    if name not in _DTYPES:
        raise ValueError(f'compute dtype {name!r}: fp32 or bf16')
    _COMPUTE_DTYPE = _DTYPES[name]


def get_compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def packed_enabled() -> bool:
    """True exactly in the bf16 production mode: the blocks defer their
    norms into the next kernel and run the fused eval tail, and the norm
    statistics come from the moments kernel (the JAX packed path)."""
    return _COMPUTE_DTYPE == torch.bfloat16


def at_use(t: torch.Tensor) -> torch.Tensor:
    """t in the type it is used in: bf16 in the production mode, else its
    own (fp32, or the fp64 of a float64 reference model)."""
    return t.to(torch.bfloat16) if packed_enabled() else t


class SphericalPointCloud(NamedTuple):
    """xyz [b, p, 3]; feats [b, p, a, c]; anchors [a, 3, 3] or None."""
    xyz: torch.Tensor
    feats: torch.Tensor
    anchors: Optional[torch.Tensor]


def get_occupancy_features(pc: torch.Tensor, n_anchor: int) -> torch.Tensor:
    """[b, p, 3 or 6] -> occupancy-ones features [b, p, na, 1], with the
    normals of a 6-channel cloud (its last three) appended per anchor,
    rotated by each anchor of the convention in force ([b, p, na, 4]; one
    anchor: the normals as they are), as the JAX ``get_occupancy_features``
    (use_center=False) computes them."""
    b, p, nd = pc.shape
    feats = pc.new_ones(b, p, n_anchor, 1)
    if nd == 6:
        ns = pc[:, :, 3:]
        if n_anchor > 1:
            anchors = torch.from_numpy(icosahedron.get_anchors(n_anchor)).to(
                pc)
            fn = torch.einsum('bpi,aij->bpaj', ns, anchors)
        else:
            fn = ns[:, :, None, :]
        feats = torch.cat([feats, fn], dim=-1)
    return feats


def preprocess_input(x: torch.Tensor, na: int) -> SphericalPointCloud:
    """[b, p, 3 or 6] -> SphericalPointCloud of the coordinates and their
    occupancy features (``get_occupancy_features``; the model's call,
    add_center=False, of the JAX ``preprocess_input``)."""
    return SphericalPointCloud(x[:, :, :3].contiguous(),
                               get_occupancy_features(x, na), None)


def rotated_kernels(anchors: torch.Tensor, kernels_: torch.Tensor):
    """(rk [a, k, 3] = R_a kappa_k, k2 [k] = |kappa_k|^2)."""
    rk = torch.einsum('aij,kj->aki', anchors, kernels_).contiguous()
    return rk, (kernels_ ** 2).sum(-1).contiguous()


def inter_so3conv_fused(xyz: torch.Tensor, feats: torch.Tensor, stride: int,
                        n_neighbor: int, anchors: torch.Tensor,
                        kernels_: torch.Tensor, radius: float, sigma: float,
                        W: torch.Tensor, lazy_sample: bool = True,
                        ones_input: bool = False):
    """Grouping + anchor weights + neighbor contraction + the learned
    BasicSO3Conv product, in the compute dtype. W: [k, c_in, c_out] fp32
    (cast at use).

    Returns (inter_idx, new_xyz, out [b, p2, a, c_out], sample_idx).

    The occupancy-ones input of block 0 (c_in == 1) runs the ones kernel:
    every gathered feature is 1, so the contraction is the anchor-weight sum
    F [b, p2, a, k] (no gradient: it depends on the coordinates only), and
    the learned [k, c_out] product is one torch matmul under autograd, with
    fp32 accumulation. Every layer with a real feature table goes through
    ``InterConvFn`` (the kernels, or the plain versions on the CPU); inside
    ``kernels.plain()`` it calls the plain forward and lets autograd
    differentiate it, so the card's plain path shares no backward formula
    with the kernel path.
    """
    grouped_xyz, inter_idx, sample_idx, new_xyz = \
        sampling.inter_grouping_ball(xyz, stride, radius, n_neighbor,
                                     lazy_sample)
    rk, k2 = rotated_kernels(anchors, kernels_)
    if ones_input and feats.shape[-1] == 1:
        ones = _ones.ones_conv_plain if kernels.plain_forced() else \
            _ones.ones_conv
        W0 = at_use(W[:, 0, :])
        F = ones(grouped_xyz.contiguous(), rk, k2, float(sigma), W0.dtype)
        out = torch.matmul(F, W0)
        return inter_idx, new_xyz, out, sample_idx
    args = (grouped_xyz.contiguous(), inter_idx, at_use(feats).contiguous(),
            rk, k2, at_use(W).contiguous(), float(sigma))
    if kernels.plain_forced():
        out = _ic.inter_conv_plain(*args)
    else:
        out = _ic.InterConvFn.apply(*args)
    return inter_idx, new_xyz, out, sample_idx


class InterGrouping(NamedTuple):
    """One inter conv's grouping, the port's form of the JAX package's
    (inter_idx, inter_w) pair: the ball indices [b, p2, nn] int32 and the
    localized neighbor coordinates gx [b, p2, nn, 3], with the rotated
    kernel points rk [na, K, 3], k2 [K] and sigma of the layer that made
    it, which together fix its anchor weights inter_w [b, p2, nn, na, K]:
    the W-off kernels compute them from these, so a layer that reuses the
    grouping runs with the weights it was made with."""
    idx: torch.Tensor
    gx: torch.Tensor
    rk: torch.Tensor
    k2: torch.Tensor
    sigma: float


class GroupingCache:
    """The grouping that a block's consecutive stride-1 layers share on the
    unfused path (JAX ``nn/blocks.py:249-279``): each unfused inter conv
    reads ``grouping`` (None: make its own) and leaves its own there; a
    fused one leaves None (it makes no inter_w), and the sequencer resets it
    after any strided layer."""

    def __init__(self):
        self.grouping: Optional[InterGrouping] = None


def unpack_feats(feats: Optional[torch.Tensor],
                 na: int) -> Optional[torch.Tensor]:
    """Packed [b, p, na*c] -> [b, p, na, c]; identity on 4D or None (the
    port's activations are 4D in both dtypes)."""
    if feats is not None and feats.dim() == 3 and na > 1:
        b, p, L = feats.shape
        return feats.reshape(b, p, na, L // na)
    return feats


def inter_conv_anchor_weights(grouped_xyz: torch.Tensor, anchors: torch.Tensor,
                              kernels_: torch.Tensor,
                              sigma: float) -> torch.Tensor:
    """Kernel-point influence weights under each anchor rotation: gx
    [b, p, n, 3], anchors [a, 3, 3], kernels [k, 3] -> w [b, p, n, a, k] =
    relu(1 - ||gx - R_a kappa_k||^2 / sigma), by the expansion
    |gx|^2 + |kappa|^2 - 2 gx . R_a kappa."""
    rk, k2 = rotated_kernels(anchors, kernels_)
    return _ic.anchor_weights(grouped_xyz, rk, k2, sigma)


def inter_feat_grouping(grouped_feats: torch.Tensor,
                        inter_w: torch.Tensor) -> torch.Tensor:
    """Neighbor contraction: grouped_feats [b, p, n, a, c], inter_w
    [b, p, n, a, k] -> [b, p, a, k, c]."""
    return torch.einsum('bpnak,bpnac->bpakc', inter_w, grouped_feats)


def inter_blurring(inter_idx: torch.Tensor, feats: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """alpha * f + (1 - alpha) * the neighborhood mean (the shadow index
    reads a zero row), in fp32, rounded to feats' type."""
    f = _build.widen(feats)
    grouped = sampling.gather_points(sampling.add_shadow_feature(f),
                                     inter_idx)
    return (alpha * f + (1 - alpha) * grouped.mean(dim=2)).to(feats.dtype)


def inter_pooling(inter_idx: torch.Tensor, sample_idx: torch.Tensor,
                  feats: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """The strided blur: alpha * f at the samples + (1 - alpha) * their
    neighborhood mean, in fp32, rounded to feats' type."""
    f = _build.widen(feats)
    grouped = sampling.gather_points(sampling.add_shadow_feature(f),
                                     inter_idx)
    return (alpha * sampling.gather_points(f, sample_idx)
            + (1 - alpha) * grouped.mean(dim=2)).to(feats.dtype)


def inter_so3conv_blurring(xyz: torch.Tensor, feats: torch.Tensor,
                           n_neighbor: int, radius: float, stride: int,
                           inter_idx: Optional[torch.Tensor] = None,
                           lazy_sample: bool = True):
    """The mean-neighborhood low-pass before a conv -> (feats, xyz): at
    stride 1 the blur in place, else the strided blur onto the samples.
    A given ``inter_idx`` (a cached grouping's) serves as the neighborhoods;
    with it and stride > 1 there are no samples to pool onto, and the call
    raises as the JAX function does."""
    if inter_idx is None:
        _, inter_idx, sample_idx, sample_xyz = sampling.inter_grouping_ball(
            xyz, stride, radius, n_neighbor, lazy_sample)
    elif stride != 1:
        raise UnboundLocalError(
            "cannot access local variable 'sample_idx': a strided blur "
            "over a cached grouping has no samples (as in the JAX "
            "package's inter_so3conv_blurring)")
    if stride == 1:
        return inter_blurring(inter_idx, feats), xyz
    return inter_pooling(inter_idx, sample_idx, feats), sample_xyz


def inter_conv_f(grouping: InterGrouping, feats: torch.Tensor,
                 ones_input: bool = False) -> torch.Tensor:
    """F [b, p2, na, K, c] of ``grouping`` over feats [b, q, na, c] in the
    compute dtype: the W-off inter conv through ``InterFFn`` (its backward
    the W-off dG), or its plain version under autograd inside
    ``kernels.plain()``. The occupancy-ones input (c == 1) is the ones
    kernel's anchor-weight sum, which needs no gather (no gradient: it
    depends on the coordinates only)."""
    g = grouping
    if ones_input and feats.shape[-1] == 1:
        ones = _ones.ones_conv_plain if kernels.plain_forced() else \
            _ones.ones_conv
        return ones(g.gx, g.rk, g.k2, g.sigma,
                    at_use(feats).dtype)[..., None]
    args = (g.gx, g.idx, at_use(feats).contiguous(), g.rk, g.k2, g.sigma)
    if kernels.plain_forced():
        return _ic.inter_conv_f_plain(*args)
    return _ic.InterFFn.apply(*args)


def inter_so3conv_grouping(xyz: torch.Tensor, feats: torch.Tensor,
                           stride: int, n_neighbor: int,
                           anchors: torch.Tensor, kernels_: torch.Tensor,
                           radius: float, sigma: float,
                           grouping: Optional[InterGrouping] = None,
                           lazy_sample: bool = True,
                           pooling: Optional[str] = None,
                           ones_input: bool = False):
    """The unfused inter conv up to its learned product (JAX
    ``inter_so3conv_grouping``): the blur where ``pooling`` asks for one
    (stride > 1 and c > 1; 'stride': onto the samples with int(n_neighbor
    * stride ** 0.5) neighbors, the conv then at stride 1; 'no-stride': in
    place with n_neighbor, the conv at its stride; any other mode raises),
    the grouping (``grouping``, a cached one, unless a blur ran), and F.

    Returns (grouping, new_xyz, F [b, p2, na, K, c], sample_idx); with a
    cached grouping new_xyz is xyz and sample_idx None."""
    if pooling is not None and stride > 1 and feats.shape[-1] > 1:
        if pooling == 'stride':
            pool_stride, stride_nn, stride = \
                stride, int(n_neighbor * stride ** 0.5), 1
        elif pooling == 'no-stride':
            pool_stride, stride_nn = 1, n_neighbor
        else:
            raise NotImplementedError(f'pooling mode {pooling}')
        feats, xyz = inter_so3conv_blurring(
            xyz, feats, stride_nn, radius, pool_stride,
            None if grouping is None else grouping.idx, lazy_sample)
        grouping = None
    if grouping is None:
        gx, idx, sample_idx, new_xyz = sampling.inter_grouping_ball(
            xyz, stride, radius, n_neighbor, lazy_sample)
        rk, k2 = rotated_kernels(anchors, kernels_)
        grouping = InterGrouping(idx, gx.contiguous(), rk, k2, float(sigma))
    else:
        sample_idx, new_xyz = None, xyz
    return (grouping, new_xyz, inter_conv_f(grouping, feats, ones_input),
            sample_idx)


def conv_product(F: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The learned BasicSO3Conv product of the unfused path: F
    [b, p, na, K, c] x W [K, c, d] (fp32, cast at use) -> [b, p, na, d] in
    F's type, one torch matmul summed in fp32."""
    b, p, na, K, c = F.shape
    W2 = W.to(F.dtype).reshape(K * c, -1)
    return (F.reshape(-1, K * c) @ W2).reshape(b, p, na, -1)


def intra_so3conv(feats: torch.Tensor, trace_idx: torch.Tensor,
                  inv_idx: torch.Tensor, W: torch.Tensor,
                  prenorm: Optional[torch.Tensor] = None,
                  slope: float = _build.LEAKY_SLOPE) -> torch.Tensor:
    """Rotation-group conv over the 60x12 adjacency: feats [b, p, 60, c],
    trace_idx and its inverse inv_idx [60, 12] int32, W [12, c, d] fp32
    (cast at use) -> [b, p, 60, d] in the compute dtype. Through
    ``IntraConvFn``, or the plain forward under autograd inside
    ``kernels.plain()``.

    prenorm: the preceding inter conv's deferred norm, fp32 lanes
    [1 or b, 2, 60*c] (scale, shift), applied on load with its activation,
    the leaky ReLU of ``slope`` (the PRENORM kernel, through
    ``IntraConvPrenormFn``; production mode)."""
    feats, W = at_use(feats).contiguous(), at_use(W).contiguous()
    if prenorm is not None:
        ss = prenorm.contiguous()
        if kernels.plain_forced():
            return _intra.intra_conv_prenorm_plain(feats, ss, trace_idx, W,
                                                   slope)
        return _intra.IntraConvPrenormFn.apply(feats, ss, trace_idx, inv_idx,
                                               W, slope)
    if kernels.plain_forced():
        return _intra.intra_conv_plain(feats, trace_idx, W)
    return _intra.IntraConvFn.apply(feats, trace_idx, inv_idx, W)


def moments(x: torch.Tensor):
    """Per-lane (sum, sum of squares) fp32 [b, 60*c] of x [b, p, 60, c]
    over the points: the moments kernel through ``MomentsFn``, or its plain
    version inside ``kernels.plain()``; both differentiable."""
    b, p = x.shape[:2]
    x3 = x.contiguous().reshape(b, p, -1)
    if kernels.plain_forced():
        return _mom.moments_plain(x3)
    return _mom.MomentsFn.apply(x3)


def grouped_conv1x1(x: torch.Tensor, W: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """One [c, d] weight over every anchor of x [b, p, a, c], plus bias:
    the grouped-conv kernel through ``GroupedConvFn`` (W cast to x's type,
    bias fp32), or its plain version under autograd inside
    ``kernels.plain()``."""
    fn = _gc.grouped_conv_plain if kernels.plain_forced() else \
        _gc.GroupedConvFn.apply
    return fn(x.contiguous(), W.to(x.dtype).contiguous(), bias.float())


def separable_tail(x: torch.Tensor, W: torch.Tensor, bias: torch.Tensor,
                   ssk: torch.Tensor, y: torch.Tensor, ssm: torch.Tensor,
                   slope: float = _build.LEAKY_SLOPE) -> torch.Tensor:
    """The fused eval tail of a separable block,
    act(y * ssm0 + ssm1) + act((x @ W + bias) * ssk0 + ssk1), rounded once
    (the grouped-conv kernel's tail epilogue), act the leaky ReLU of
    ``slope``."""
    fn = _gc.grouped_conv_tail_plain if kernels.plain_forced() else \
        _gc.grouped_conv_tail
    return fn(x.contiguous(), W.to(x.dtype).contiguous(), bias.float(),
              ssk.contiguous(), y.contiguous(), ssm.contiguous(), slope)


# elements of a chunk's [pairs, ks * a] weights in initial_anchor_query
_QUERY_CHUNK = 2 ** 24


def initial_anchor_query(frag: torch.Tensor, centers: torch.Tensor,
                         kernels_: torch.Tensor, radius: float, sigma: float):
    """Density-weighted anchor occupancy of a raw fragment against each
    center's rotated kernel points (JAX ``ops/so3conv.py:780-803``, plain
    torch as the JAX package computes it in XLA): frag [m, 3], centers
    [b, nc, 3], kernels [ks, a, 3] -> (weights [b, nc, a, ks], counts
    [b, nc, a, ks]). A weight sums relu(1 - |point - center - kappa|^2 /
    sigma) over the fragment's points within ``radius`` of the center
    (distance <= radius), a count is their number. Only the (center, point)
    pairs within the radius are formed, in chunks of pairs, where the JAX
    function forms all [b, nc, m, ks, a]; the weights are summed over a
    center's points in another order."""
    b, nc, _ = centers.shape
    ks, na, _ = kernels_.shape
    flat = centers.reshape(-1, 3)
    in_ball = torch.linalg.norm(flat[:, None, :] - frag[None], dim=-1) \
        <= radius                                           # [b * nc, m]
    counts = in_ball.sum(dim=1).to(frag.dtype)
    ci, mi = in_ball.nonzero(as_tuple=True)
    kflat = kernels_.reshape(-1, 3)                         # [ks * na, 3]
    weights = centers.new_zeros(b * nc, ks * na)
    step = max(1, _QUERY_CHUNK // (ks * na))
    for s in range(0, ci.shape[0], step):
        rel = frag[mi[s:s + step]] - flat[ci[s:s + step]]    # [pairs, 3]
        d2 = ((rel[:, None, :] - kflat) ** 2).sum(-1)
        weights.index_add_(0, ci[s:s + step], torch.relu(1.0 - d2 / sigma))
    weights = weights.reshape(b, nc, ks, na).transpose(2, 3)
    return weights, counts.reshape(b, nc, 1, 1).expand(weights.shape)


def pointnet_so3_coords(xyz: torch.Tensor, anchors: torch.Tensor):
    """Per-anchor inversely-rotated centered coordinates:
    [b, p, 3] x [a, 3, 3] -> [b, p, a, 3]."""
    xyz = xyz - xyz.mean(dim=1, keepdim=True)
    return torch.einsum('aji,bpj->bpai', anchors, xyz)
