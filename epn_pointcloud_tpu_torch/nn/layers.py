"""Core equivariant layers (counterpart of ``epn_pointcloud_tpu/nn/layers.py``),
channels-last [b, p, a, c].

Parameters keep the original EPN shapes and names, so a state_dict maps onto
the JAX variable tree through ``epn_pointcloud_tpu/compat.py``:

  * BasicSO3Conv ``W``      [c_out, c_in * k] (view of [c_out, c_in, k])
  * Dense1x1 ``weight``     [c_out, c_in, 1, 1] (Conv2d), [c_out, c_in, 1]
                            (Conv1d) or [c_out, c_in] (Linear), ``bias`` [c_out]
  * BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var``

Initialization follows the same rules (``init_parameters``): SO(3) conv
weights xavier-normal with gain sqrt(2) and torch fans (c*k, d*k); 1x1 convs
kaiming-uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in)) for weight and bias.

Parameters stay fp32 in both compute dtypes; in the bf16 production mode
(``ops.so3conv.packed_enabled()``) weights are cast at use, activations stay
bf16 between layers, and norms compute in fp32 and round once.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import icosahedron, kernel_points, sampling, so3conv
from ..ops.kernels.build import LEAKY_SLOPE, widen
from ..ops.kernels.moments import moments_plain
from ..ops.so3conv import SphericalPointCloud
from ..parallel import collectives, mesh

KERNEL_CONDENSE_RATIO = kernel_points.KERNEL_CONDENSE_RATIO


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """torch's leaky ReLU, slope LEAKY_SLOPE (its subgradient at 0 is the
    slope, which the JAX package had to patch in by hand)."""
    return F.leaky_relu(x, LEAKY_SLOPE)


# jax.nn's elementwise activations written as JAX writes them where torch's
# own function takes another subgradient at a kink (hard_tanh: 1 at +-1,
# torch's 0; hard_silu: x * hard_sigmoid(x), 0 at -3 and 1 at 3, torch's
# hardswish -0.5 and 1.5) or where torch has none; torch.maximum and
# torch.minimum split a tie's gradient in halves, as jnp's do
def _hard_tanh(x):
    return torch.where(x > 1, x.new_ones(()), torch.where(
        x < -1, -x.new_ones(()), x))


def _hard_silu(x):
    return x * F.hardsigmoid(x)


def _sparse_plus(x):
    return torch.where(x <= -1.0, x.new_zeros(()),
                       torch.where(x >= 1.0, x, (x + 1.0) ** 2 / 4))


def _sparse_sigmoid(x):
    return 0.5 * torch.minimum(torch.maximum(x + 1.0, x.new_zeros(())),
                               x.new_full((), 2.0))


def _squareplus(x):
    return (x + torch.sqrt(x * x + 4)) / 2


def _log1mexp(x):
    return torch.where(x < math.log(2.0), torch.log(-torch.expm1(-x)),
                       torch.log1p(-torch.exp(-x)))


def _identity(x):
    return x


# every elementwise activation of jax.nn (0.9.0) by its name there, the
# torch function of the same formula (jax.nn.gelu's default is its tanh
# approximation)
ACTIVATIONS = {
    'relu': torch.relu, 'relu6': F.relu6, 'elu': F.elu, 'selu': F.selu,
    'celu': F.celu, 'gelu': functools.partial(F.gelu, approximate='tanh'),
    'silu': F.silu, 'swish': F.silu, 'sigmoid': torch.sigmoid,
    'tanh': torch.tanh, 'softplus': F.softplus, 'soft_sign': F.softsign,
    'log_sigmoid': F.logsigmoid, 'hard_sigmoid': F.hardsigmoid,
    'hard_silu': _hard_silu, 'hard_swish': _hard_silu,
    'hard_tanh': _hard_tanh, 'mish': F.mish, 'identity': _identity,
    'sparse_plus': _sparse_plus, 'sparse_sigmoid': _sparse_sigmoid,
    'squareplus': _squareplus, 'log1mexp': _log1mexp,
}
# the other names of jax.nn, which are no elementwise activation: each
# normalizes or reduces over an axis, reshapes it, or takes other operands
REFUSED_ACTIVATIONS = ('softmax', 'log_softmax', 'glu', 'standardize',
                       'one_hot', 'logsumexp', 'logmeanexp',
                       'dot_product_attention', 'scaled_dot_general',
                       'scaled_matmul', 'get_scaled_dot_general_config',
                       'initializers')


def get_activation(name: Optional[str]):
    """The activation a block names (JAX ``nn/layers.py:get_activation``):
    None for None or 'none', torch's leaky ReLU for 'leaky_relu', else the
    elementwise jax.nn function of that name (``ACTIVATIONS``). The names
    of jax.nn that are no elementwise activation raise NotImplementedError;
    any other name raises AttributeError, as ``getattr(jax.nn, name)``
    does."""
    if name is None or name == 'none':
        return None
    if name == 'leaky_relu':
        return leaky_relu
    if name in ACTIVATIONS:
        return ACTIVATIONS[name]
    if name in REFUSED_ACTIVATIONS:
        raise NotImplementedError(
            f'activation {name!r}: not an elementwise function of a feature '
            f'(it normalizes or reduces over an axis, reshapes it, or takes '
            f'other operands), so no block applies it; refused on purpose')
    raise AttributeError(f'jax.nn has no activation {name!r}')


class Dropout(nn.Module):
    """Dropout as the JAX package's blocks apply it (``flax.linen.Dropout``):
    in train mode each element is kept with probability 1 - rate and scaled
    by 1 / (1 - rate), in x's type; the identity in eval. The keep mask is
    drawn from ``generator`` (a ``torch.Generator`` on x's device, which the
    trainer owns and seeds from ``--seed``: ``set_dropout_generator``), else
    from torch's default generator of that device. Under data parallelism
    (``parallel.mesh.data_world() > 1``) each rank draws the mask of the
    global batch (every rank's generator is seeded alike) and keeps its
    own rows of dim 0, so a run equals the single-process run on the
    global batch."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        world = mesh.data_world()
        if world == 1:
            return torch.rand(x.shape, generator=self.generator,
                              device=x.device) < 1.0 - self.rate
        b, r = x.shape[0], mesh.data_rank()
        u = torch.rand((world * b,) + tuple(x.shape[1:]),
                       generator=self.generator, device=x.device)
        return u[r * b:(r + 1) * b] < 1.0 - self.rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if self.rate >= 1:
            return torch.zeros_like(x)
        return torch.where(self.keep_mask(x), x / (1.0 - self.rate),
                           x.new_zeros(()))


def set_dropout_generator(module: nn.Module, gen: torch.Generator) -> None:
    """Every Dropout of ``module`` draws its masks from ``gen``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = gen


class Dense1x1(nn.Module):
    """Channel-wise dense layer == Conv2d/Conv1d with a 1-wide kernel, or
    Linear, over the last axis."""

    SHAPES = {'conv2d': (1, 1), 'conv1d': (1,), 'linear': ()}

    def __init__(self, c_in: int, c_out: int, kind: str = 'conv2d'):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.weight = nn.Parameter(
            torch.empty((c_out, c_in) + self.SHAPES[kind]))
        self.bias = nn.Parameter(torch.empty(c_out))

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.c_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            self.bias.uniform_(-bound, bound, generator=gen)

    def weight_cd(self) -> torch.Tensor:
        """The [c_in, c_out] matrix of the layer."""
        return self.weight.reshape(self.c_out, self.c_in).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In x's type (weight and bias cast to it, as the JAX layer does)."""
        return x @ self.weight_cd().to(x.dtype) + self.bias.to(x.dtype)

    def grouped(self, x: torch.Tensor) -> torch.Tensor:
        """The anchor-grouped form of the production mode: one [c_in, c_out]
        weight over every anchor of x [b, p, a, c_in], fp32 accumulation
        and bias, rounded once to x's type (the grouped-conv kernel)."""
        return so3conv.grouped_conv1x1(x, self.weight_cd(), self.bias)


def _lane_sums(x: torch.Tensor, kernel_stats: bool = True):
    """Per-lane fp32 (sum, sum of squares) of x [b, p, na, c] over the
    points: [b, na*c] from the moments kernel, or (``kernel_stats=False``)
    [b, c] from plain torch sums over (p, na), the JAX package's unpacked
    ``_moments``, which layer 0's rank-1 skip takes."""
    if kernel_stats:
        return so3conv.moments(x)
    b, p, na, c = x.shape
    return moments_plain(x.reshape(b, p * na, c))


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) over [b, p, a, c]: each (b, c) slice is
    normalized over (p, a) with its biased variance: two-pass in the fp32
    mode, and in the bf16 production mode (``so3conv.packed_enabled()``) the
    one-pass E[x^2] - E[x]^2 (clamped at 0) in fp32 from ``_lane_sums``
    (the JAX package's ``_packed_instance_norm``, or its unpacked
    ``_moments`` with ``kernel_stats=False``), differentiable."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def _packed_stats(self, x: torch.Tensor, kernel_stats: bool = True):
        """(mean, rsig) fp32 [b, 1, 1, c] from per-lane sums."""
        b, p, na, c = x.shape
        s, sq = _lane_sums(x, kernel_stats)
        n = p * na
        mean = s.reshape(b, -1, c).sum(dim=1) / n
        var = torch.clamp(sq.reshape(b, -1, c).sum(dim=1) / n - mean * mean,
                          min=0.0)
        return (mean.reshape(b, 1, 1, c),
                torch.rsqrt(var + self.eps).reshape(b, 1, 1, c))

    def forward(self, x: torch.Tensor,
                kernel_stats: bool = True) -> torch.Tensor:
        if not so3conv.packed_enabled():
            var, mean = torch.var_mean(x, dim=(1, 2), correction=0,
                                       keepdim=True)
            return (x - mean) * torch.rsqrt(var + self.eps)
        mean, rsig = self._packed_stats(x, kernel_stats)
        return ((x.float() - mean) * rsig).to(x.dtype)

    def scale_shift(self, groups: int, x: torch.Tensor) -> torch.Tensor:
        """The norm of x [b, p, groups, c] folded to per-lane fp32 [b, 2,
        groups*c] (scale; shift; a fold a sample), with x * scale + shift ==
        the normalized x: for a kernel that applies it on load (production
        mode). The call matches ``BatchNorm.scale_shift``."""
        b, c = x.shape[0], x.shape[-1]
        mean, rsig = self._packed_stats(x)
        ss = torch.stack([rsig, -mean * rsig], dim=1)       # [b, 2, 1, 1, c]
        return ss.reshape(b, 2, 1, c).expand(b, 2, groups, c).reshape(
            b, 2, groups * c)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, affine. Train mode
    normalizes with the biased batch variance and moves the running
    statistics by momentum 0.1 with the unbiased one (torch semantics, as
    the JAX package's ``BatchNorm``); eval mode uses the running
    statistics.

    In the bf16 production mode (``so3conv.packed_enabled()``) a bf16
    [b, p, na, c] input in train mode takes the JAX package's packed
    statistics: one-pass fp32 E[x^2] - E[x]^2 (clamped at 0) from per-lane
    sums (the moments kernel; plain torch sums for the unpacked layer-0
    skip, ``kernel_stats=False``), differentiable, with the output computed
    in fp32 and rounded once. fp32 keeps ``F.batch_norm``.

    Under data parallelism (a data group of more than one rank installed,
    ``parallel.mesh.set_data_group``) train mode takes the global batch's
    statistics, as the JAX package's BatchNorm reduces over the global
    array: the packed per-lane sums, reduced over the local batch, go
    through one differentiable all-reduce before the one-pass mean and
    variance are formed; fp32 gathers each rank's mean and sum of squared
    deviations (``torch.var_mean``, a Welford reduction, as
    ``F.batch_norm``'s) through one differentiable all-gather and merges
    them in rank order (``_merge_moments``). The running variance's
    unbiased factor counts the global batch, so every rank's running
    statistics stay equal."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def reset_parameters(self, gen: torch.Generator = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _one_pass(self, x: torch.Tensor) -> bool:
        return (self.training and so3conv.packed_enabled()
                and x.dtype == torch.bfloat16 and x.dim() == 4)

    def _batch_stats(self, x: torch.Tensor, kernel_stats: bool = True):
        """(mean, biased var) fp32 [c] of x [b, p, na, c] in one pass, and
        the running statistics moved (the unbiased variance, momentum 0.1)."""
        b, p, na, c = x.shape
        n = b * p * na
        s, sq = _lane_sums(x, kernel_stats)
        world = mesh.data_world()
        if world > 1:
            s, sq = collectives.all_reduce_sum(
                torch.stack([s.sum(0), sq.sum(0)]), mesh.data_group())
            n *= world
        mean = s.reshape(-1, c).sum(0) / n
        var = torch.clamp(sq.reshape(-1, c).sum(0) / n - mean * mean,
                          min=0.0)
        self._move_running(mean, var, n)
        return mean, var

    def _move_running(self, mean, var, n: int) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the data group's global batch in fp32: each
        rank's Welford mean and sum of squared deviations, all-gathered
        and merged (``_merge_moments``) into the global mean and biased
        variance."""
        c = x.shape[-1]
        xf = widen(x).reshape(-1, c)
        m = xf.shape[0]
        var, mean = torch.var_mean(xf, dim=0, correction=0)
        parts = collectives.all_gather_batch(
            torch.stack([mean, var * m])[None], mesh.data_group())
        mean, var = _merge_moments(parts, m)
        n = m * mesh.data_world()
        self._move_running(mean, var, n)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return y.reshape(x.shape).to(x.dtype)

    def forward(self, x: torch.Tensor,
                kernel_stats: bool = True) -> torch.Tensor:
        if self._one_pass(x):
            mean, var = self._batch_stats(x, kernel_stats)
            scale = torch.rsqrt(var + self.eps) * self.weight
            return ((x.float() - mean) * scale + self.bias).to(x.dtype)
        if self.training and mesh.data_world() > 1:
            return self._global_forward(x)
        if self.training:
            c = x.shape[-1]
            y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=True, momentum=self.momentum,
                             eps=self.eps)
            return y.reshape(x.shape)
        rsig = torch.rsqrt(self.running_var + self.eps)
        y = (widen(x) - self.running_mean) * rsig * self.weight + self.bias
        return y.to(x.dtype)

    def scale_shift(self, groups: int, x: torch.Tensor = None) -> torch.Tensor:
        """The norm folded to per-lane fp32 [1, 2, groups*c] (scale; shift),
        the lanes anchor-major: x * scale + shift == the normalized x. Eval
        mode folds the running statistics; train mode (production mode)
        the one-pass batch statistics of x [b, p, groups, c], differentiable,
        and moves the running statistics."""
        if self.training:
            if x is None:
                raise ValueError('BatchNorm.scale_shift in train mode needs '
                                 'the batch it normalizes')
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * scale
        return torch.stack([scale, shift]).repeat(1, groups)[None]


def _merge_moments(parts: torch.Tensor, m: int):
    """The (mean, biased variance) [c] of the union of the ranks' equal
    shares of m rows, from their [ranks, 2, c] (mean, sum of squared
    deviations), merged in rank order by Chan's pairwise update: the mean
    moves by the other share's difference from it, so a channel constant
    over the global batch keeps its value exactly and a variance of 0, as
    ``F.batch_norm``'s Welford reduction does in one process (a sum over
    n rounds such a mean, and normalizing by sqrt(eps) amplifies the
    rounding: block 0's skip BatchNorm sees the constant occupancy
    field)."""
    mean, m2, n = parts[0, 0], parts[0, 1], m
    for r in range(1, parts.shape[0]):
        delta = parts[r, 0] - mean
        mean = mean + delta * (m / (n + m))
        m2 = m2 + parts[r, 1] + delta * delta * (n * m / (n + m))
        n += m
    return mean, m2 / n


def make_norm(norm, c: int) -> nn.Module:
    """The norm a block names over c channels: None (the inv model's blocks)
    or 'InstanceNorm2d' -> InstanceNorm, 'BatchNorm2d' / 'BatchNorm1d' ->
    BatchNorm (JAX ``nn/layers.py:406-413``)."""
    if norm is None or norm == 'InstanceNorm2d':
        return InstanceNorm()
    if norm in ('BatchNorm2d', 'BatchNorm1d'):
        return BatchNorm(c)
    raise ValueError(f'unsupported norm {norm}')


class BasicSO3Conv(nn.Module):
    """The learned SO(3) conv weight, stored as the original [d, c*k]."""

    def __init__(self, dim_in: int, dim_out: int, n_kernel: int):
        super().__init__()
        self.dim_in, self.dim_out, self.n_kernel = dim_in, dim_out, n_kernel
        self.W = nn.Parameter(torch.empty(dim_out, dim_in * n_kernel))

    def reset_parameters(self, gen: torch.Generator):
        fan = self.dim_in * self.n_kernel + self.dim_out * self.n_kernel
        std = math.sqrt(2.0) * math.sqrt(2.0 / fan)
        with torch.no_grad():
            self.W.normal_(0.0, std, generator=gen)

    def weight_kcd(self) -> torch.Tensor:
        """[k, c_in, c_out] view used by the kernels."""
        return self.W.reshape(self.dim_out, self.dim_in, self.n_kernel) \
            .permute(2, 1, 0).contiguous()


@functools.lru_cache(maxsize=None)
def _constant(kind: str, arg, convention: str, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """One anchor-convention constant on ``device``: the anchors of
    kanchor ``arg`` (float ``dtype``), the kernel points of (radius,
    kernel_size) ``arg`` (float ``dtype``), the intra adjacency
    ``trace_idx`` / its inverse ``inv_idx`` (int32), or the relabel of the
    full group's anchors into kanchor ``arg``'s subset (``relabel``,
    int64). Built outside inference mode whatever the caller's, so that a
    constant first read by an eval under ``torch.inference_mode()`` can
    still be saved for a later train step's backward."""
    assert convention == icosahedron.get_convention()
    with torch.inference_mode(False):
        if kind == 'anchors':
            host = icosahedron.get_anchors(arg)
        elif kind == 'kernels':
            radius, kernel_size = arg
            host = kernel_points.get_spherical_kernel_points(
                KERNEL_CONDENSE_RATIO * radius, kernel_size)
        elif kind == 'relabel':
            return torch.from_numpy(
                icosahedron.anchor_subset_relabel_map(arg)).to(device)
        else:
            adj = (icosahedron.get_intra_idx() if kind == 'trace_idx' else
                   icosahedron.get_intra_inv_idx())
            return torch.from_numpy(adj.astype('int32')).to(device)
        return torch.from_numpy(host).to(device, dtype)


def convention_constant(kind: str, arg, device: torch.device,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The constant ``kind`` (``_constant``) of the anchor convention in
    force when it is read, on ``device`` in ``dtype``. The modules
    look their anchors, kernel points and adjacency up at each use, so a
    model built under one convention runs with the constants of the one in
    force (the JAX package flushes its caches on a switch to the same
    end)."""
    return _constant(kind, arg, icosahedron.get_convention(), device, dtype)


def _like(kind: str, arg, param: torch.Tensor) -> torch.Tensor:
    """``convention_constant`` on a module parameter's device, in its
    type (a float64 model's anchors are float64)."""
    return convention_constant(kind, arg, param.device, param.dtype)


class InterSO3Conv(nn.Module):
    """Spatial SO(3)-anchor conv: ball grouping + anchor-rotated kernel
    weights + learned conv product, at kanchor 60, 40, 20 or 1 (the anchor
    subsets of ``select_anchors``). As in the JAX package
    (``nn/layers.py:578-607``) it runs the fused path unless ``pooling`` is
    set ('stride' or 'no-stride') or a cached grouping is handed in: then
    the unfused path (``so3conv.inter_so3conv_grouping``: the blur, the
    grouping, the W-off F) and the learned product as a torch matmul."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 stride: int, radius: float, sigma: float, n_neighbor: int,
                 lazy_sample: bool = True, kanchor: int = 60,
                 pooling: Optional[str] = None):
        super().__init__()
        self.stride, self.radius, self.sigma = stride, radius, sigma
        self.n_neighbor, self.lazy_sample = n_neighbor, lazy_sample
        self.kernel_size, self.kanchor = kernel_size, kanchor
        self.pooling = None if pooling in (None, 'none') else pooling
        self.basic_conv = BasicSO3Conv(
            dim_in, dim_out,
            kernel_points.KERNEL_SIZE_TO_NPOINTS[kernel_size])

    @property
    def anchors(self) -> torch.Tensor:
        return _like('anchors', self.kanchor, self.basic_conv.W)

    @property
    def kernels(self) -> torch.Tensor:
        return _like('kernels', (self.radius, self.kernel_size),
                     self.basic_conv.W)

    def forward(self, x: SphericalPointCloud, ones_input: bool = False,
                cache: Optional[so3conv.GroupingCache] = None):
        """cache: the block's shared grouping (``so3conv.GroupingCache``):
        an unfused conv reuses the one it holds and leaves its own there, a
        fused one leaves None."""
        if x.feats.shape[-1] != self.basic_conv.dim_in:
            # a 6-channel cloud's 4 occupancy channels (ones and the rotated
            # normals) against the builder's dim_in = 1: the JAX package's
            # einsum broadcasts its [24, 1, d] W over them
            # (epn_pointcloud_tpu/ops/so3conv.py:626), i.e. convolves their
            # sum, and the original EPN's matmul refuses the shape
            raise NotImplementedError(
                f'inter conv of dim_in {self.basic_conv.dim_in} on '
                f'{x.feats.shape[-1]}-channel features: the normals input '
                f'of a 6-channel cloud reaches a model built for 1 channel, '
                f'where the JAX package convolves the sum of the occupancy '
                f'and rotated normal channels with one weight (a broadcast '
                f'at its ops/so3conv.py:626), a function the original EPN '
                f'does not define (ROADMAP section C)')
        grouping = None if cache is None else cache.grouping
        if self.pooling is None and grouping is None:
            _, xyz, feats, sample_idx = so3conv.inter_so3conv_fused(
                x.xyz, x.feats, self.stride, self.n_neighbor, self.anchors,
                self.kernels, self.radius, self.sigma,
                self.basic_conv.weight_kcd(), lazy_sample=self.lazy_sample,
                ones_input=ones_input)
        else:
            grouping, xyz, F, sample_idx = so3conv.inter_so3conv_grouping(
                x.xyz, x.feats, self.stride, self.n_neighbor, self.anchors,
                self.kernels, self.radius, self.sigma, grouping,
                self.lazy_sample, self.pooling, ones_input)
            feats = so3conv.conv_product(F, self.basic_conv.weight_kcd())
        if cache is not None:
            cache.grouping = grouping
        return sample_idx, SphericalPointCloud(xyz, feats, self.anchors)


class IntraSO3Conv(nn.Module):
    """Rotation-group conv over the 60x12 group adjacency (kanchor 60)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.basic_conv = BasicSO3Conv(dim_in, dim_out,
                                       icosahedron.get_intra_idx().shape[1])

    @property
    def trace_idx(self) -> torch.Tensor:
        return _like('trace_idx', None, self.basic_conv.W)

    @property
    def inv_idx(self) -> torch.Tensor:
        return _like('inv_idx', None, self.basic_conv.W)

    @property
    def anchors(self) -> torch.Tensor:
        return _like('anchors', 60, self.basic_conv.W)

    def forward(self, x: SphericalPointCloud, prenorm=None,
                slope: float = LEAKY_SLOPE) -> SphericalPointCloud:
        """prenorm: the preceding norm folded to fp32 lanes [1 or b, 2,
        60*c], applied on load with the preceding activation, the leaky
        ReLU of ``slope`` (production mode)."""
        out = so3conv.intra_so3conv(x.feats, self.trace_idx, self.inv_idx,
                                    self.basic_conv.weight_kcd(),
                                    prenorm=prenorm, slope=slope)
        return SphericalPointCloud(x.xyz, out, self.anchors)


class PointnetSO3Conv(nn.Module):
    """Equivariant PointNet: concat per-anchor rotated coordinates, 1x1
    conv, max over points. -> [b, a, c_out]. A single-anchor input (the inv
    head's attention-pooled field) takes the centered coordinates unrotated
    (JAX ``nn/layers.py:626-628``)."""

    def __init__(self, dim_in: int, dim_out: int, kanchor: int = 60):
        super().__init__()
        self.kanchor = kanchor
        self.embed = Dense1x1(dim_in + 3, dim_out)

    @property
    def anchors(self) -> torch.Tensor:
        return _like('anchors', self.kanchor, self.embed.weight)

    def forward(self, x: SphericalPointCloud) -> torch.Tensor:
        if x.feats.shape[2] == 1:
            xyzr = (x.xyz - x.xyz.mean(dim=1, keepdim=True))[:, :, None, :]
        else:
            xyzr = so3conv.pointnet_so3_coords(x.xyz, self.anchors)
        # fp32 from here on in both modes (the JAX concat promotes bf16)
        feats = self.embed(torch.cat([widen(x.feats), xyzr], dim=-1))
        return feats.max(dim=1).values


class KernelPropagation(nn.Module):
    """Fragment -> anchor features (JAX ``nn/layers.py:637-668``): the
    density-weighted anchor occupancy of a raw fragment around each center
    (``so3conv.initial_anchor_query``), divided by the in-radius count + 1,
    through a BasicSO3Conv of the (anchor, kernel point) weights. The
    centers are the clouds themselves when they hold ``n_center`` points,
    else their furthest-point samples (the fps kernel, not lazy)."""

    def __init__(self, dim_in: int, dim_out: int, n_center: int,
                 kernel_size: int, radius: float, sigma: float,
                 kanchor: int = 60):
        super().__init__()
        self.n_center, self.kernel_size = n_center, kernel_size
        self.radius, self.sigma, self.kanchor = radius, sigma, kanchor
        self.basic_conv = BasicSO3Conv(
            dim_in, dim_out,
            kernel_points.KERNEL_SIZE_TO_NPOINTS[kernel_size])

    @property
    def anchors(self) -> torch.Tensor:
        return _like('anchors', self.kanchor, self.basic_conv.W)

    def forward(self, frag: torch.Tensor,
                clouds: torch.Tensor) -> SphericalPointCloud:
        """frag [m, 3], clouds [b, p, 3] -> the field [b, n_center, na,
        dim_out] over the centers."""
        anchors = self.anchors
        kernels_ = _like('kernels', (self.radius, self.kernel_size),
                         self.basic_conv.W)
        rk = torch.einsum('aij,kj->kai', anchors, kernels_)  # [ks, na, 3]
        if clouds.shape[1] == self.n_center:
            centers = clouds
        else:
            _, centers = sampling.furthest_sample(clouds, self.n_center,
                                                  False)
        wts, cnt = so3conv.initial_anchor_query(frag, centers, rk,
                                                self.radius, self.sigma)
        wts = wts / (cnt + 1.0)                           # [b, nc, na, ks]
        feats = torch.einsum('bpakc,kcd->bpad', wts[..., None],
                             self.basic_conv.weight_kcd())
        return SphericalPointCloud(centers, feats, anchors)


def init_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init of every parameter, in module registration order."""
    for m in module.modules():
        if isinstance(m, (Dense1x1, BatchNorm, BasicSO3Conv)):
            m.reset_parameters(gen)
