"""Batch norms and sparse conv blocks (counterpart of
pcseqlearning_tpu.models.layers).

The batch norms are written out rather than taken from ``torch.nn``: as in
the JAX modules, the running variance follows the *biased* batch variance
(torch's BatchNorm keeps the unbiased one), ``MaskedBatchNorm`` leaves the
padding rows out of the moments, and the momentum convention is torch's
(new = (1 - m) * old + m * batch) with m = 0.01 and eps = 1e-3, the
reference's spconv norm settings. Training mode is ``module.training``.

Inside ``bn_cross_replica(group)`` every batch norm in training mode sums
its moment accumulators over the ranks of ``group`` (the JAX
``bn_cross_replica`` over a mapped axis, torch's SyncBatchNorm): first the
count and the sum (one all-reduce), then the sum of squares about the
global mean (a second one), so each rank normalises by the global batch's
moments. The all-reduce carries the gradient: its backward all-reduces the
cotangent, as psum's transpose is psum. With no group bound the moments
are the local ones, computed as before.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch import nn

from ..ops import sparse_conv as sc
from ..utils import dist_utils

# the process group whose ranks' moments the batch norms sum, when one is bound
_SYNC_GROUP = [None]


@contextmanager
def bn_cross_replica(group):
    """Bind ``group`` for the batch norms' moments (None: local moments)."""
    prev = _SYNC_GROUP[0]
    _SYNC_GROUP[0] = group
    try:
        yield
    finally:
        _SYNC_GROUP[0] = prev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the backward sums the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return dist_utils.all_reduce(x.detach().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return dist_utils.all_reduce(g.contiguous().clone(), group=ctx.group), None


def _moment_sum(x):
    """``x`` summed over the bound group's ranks."""
    return _AllReduceSum.apply(x, _SYNC_GROUP[0])


def _synced_moments(count, sums, centred_sq):
    """(mean, var) from the global count (at least 1) and sum, then the
    global sum of squares about the global mean: ``count`` [] and ``sums``
    [C] are this rank's, ``centred_sq(mean)`` gives its [C] sum of
    squares."""
    cs = _moment_sum(torch.cat([count.reshape(1), sums]))
    n = torch.clamp(cs[0], min=1.0)
    mean = cs[1:] / n
    return mean, _moment_sum(centred_sq(mean)) / n

# flax's default kernel init, variance_scaling(1.0, "fan_in",
# "truncated_normal"): a normal truncated at two standard deviations, the
# stddev corrected for the truncation
_TRUNC_STD = 0.87962566103423978


def init_fan_in(weight, fan_in, generator=None):
    """Fill ``weight`` as flax's lecun_normal would for that fan-in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return weight


class _BatchNorm(nn.Module):
    def __init__(self, channels, momentum=0.01, eps=1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _update(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)


class MaskedBatchNorm(_BatchNorm):
    """BatchNorm1d over the valid rows of a padded [V, C] table; padding
    rows come out zero."""

    def forward(self, x, valid):
        if self.training:
            w = valid.to(x.dtype)[:, None]
            if _SYNC_GROUP[0] is None:
                n = torch.clamp(w.sum(), min=1.0)
                mean = (x * w).sum(0) / n
                var = (w * (x - mean[None, :]) ** 2).sum(0) / n
            else:
                mean, var = _synced_moments(
                    w.sum(), (x * w).sum(0),
                    lambda m: (w * (x - m[None, :]) ** 2).sum(0))
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean[None, :]) * torch.rsqrt(var[None, :] + self.eps)
        y = y * self.weight[None, :] + self.bias[None, :]
        return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


class _LocalBatchNorm2d(torch.autograd.Function):
    """Training-mode batch norm of an NCHW map over its local moments:
    ``BatchNorm2d``'s forward, bit for bit (mean, variance about it,
    ((x - mean) * rsqrt(var + eps)) * weight + bias), saving only x and the
    moments for the backward, which takes the closed form dx = weight * r *
    (dy - mean(dy) - xhat * mean(dy * xhat)) (xhat = (x - mean) * r, r =
    rsqrt(var + eps)). Autograd of the composed forward keeps three more
    maps a layer, which a stride-1 BEV backbone at the Waymo grid cannot
    hold. Returns (y, mean, var); the moments carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = (1, -1, 1, 1)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        mean = x.sum((0, 2, 3)) / n
        var = ((x - mean[None, :, None, None]) ** 2).sum((0, 2, 3)) / n
        r = torch.rsqrt(var.view(c) + eps)
        y = (x - mean.view(c)) * r * weight.view(c) + bias.view(c)
        ctx.save_for_backward(x, mean, r, weight)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, weight = ctx.saved_tensors
        c = (1, -1, 1, 1)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        xhat = (x - mean.view(c)) * r
        dsum = dy.sum((0, 2, 3))
        dxhat = (dy * xhat).sum((0, 2, 3))
        dx = (weight.view(c) * r) * (dy - (dsum / n).view(c) - xhat * (dxhat / n).view(c))
        return dx, dxhat, dsum, None


class BatchNorm2d(_BatchNorm):
    """Batch norm over an NCHW map, moments over (N, H, W)."""

    def forward(self, x):
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            if _SYNC_GROUP[0] is None:
                y, mean, var = _LocalBatchNorm2d.apply(x, self.weight, self.bias, self.eps)
                self._update(mean, var)
                return y
            else:
                mean, var = _synced_moments(
                    x.new_tensor(float(n)), x.sum((0, 2, 3)),
                    lambda m: ((x - m[None, :, None, None]) ** 2).sum((0, 2, 3)))
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        c = (1, -1, 1, 1)
        return ((x - mean.view(c)) * torch.rsqrt(var.view(c) + self.eps) * self.weight.view(c)
                + self.bias.view(c))


def _sparse_weight(kernel_size, cin, cout, generator):
    k = math.prod(sc._triple(kernel_size))
    return nn.Parameter(init_fan_in(torch.empty(k, cin, cout), k * cin, generator))


def _finish(out, bn, act):
    f = out.features
    if bn is not None:
        f = bn(f, out.valid)
    if act:
        f = torch.relu(f)
    return out._replace(features=sc._mask_features(f, out.valid))


class SubMConvBlock(nn.Module):
    """SubMConv3d + BN + ReLU (the reference's post_act_block, 'subm')."""

    def __init__(self, cin, cout, kernel_size=3, use_norm=True, use_act=True,
                 dense_table_cap=sc.DENSE_TABLE_CAP, generator=None):
        super().__init__()
        self.kernel_size, self.use_act, self.dense_table_cap = kernel_size, use_act, dense_table_cap
        self.weight = _sparse_weight(kernel_size, cin, cout, generator)
        self.bn = MaskedBatchNorm(cout) if use_norm else None

    def forward(self, st: sc.SparseTensor, rulebook=None):
        out = sc.subm_conv3d(st, self.weight, kernel_size=self.kernel_size, rulebook=rulebook,
                             dense_table_cap=self.dense_table_cap)
        return _finish(out, self.bn, self.use_act)


class SparseConvBlock(nn.Module):
    """Strided SparseConv3d + BN + ReLU (post_act_block, 'spconv')."""

    def __init__(self, cin, cout, kernel_size=3, stride=2, padding=1, out_cap=None,
                 use_norm=True, use_act=True, dense_table_cap=sc.DENSE_TABLE_CAP,
                 generator=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.out_cap, self.use_act, self.dense_table_cap = out_cap, use_act, dense_table_cap
        self.weight = _sparse_weight(kernel_size, cin, cout, generator)
        self.bn = MaskedBatchNorm(cout) if use_norm else None

    def forward(self, st: sc.SparseTensor):
        out = sc.sparse_conv3d(st, self.weight, kernel_size=self.kernel_size, stride=self.stride,
                               padding=self.padding, out_cap=self.out_cap,
                               dense_table_cap=self.dense_table_cap)
        return _finish(out, self.bn, self.use_act)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block (the reference's SparseBasicBlock): two
    subm convs on one coordinate set, so one rulebook."""

    def __init__(self, channels, dense_table_cap=sc.DENSE_TABLE_CAP, generator=None):
        super().__init__()
        self.dense_table_cap = dense_table_cap
        self.conv0 = SubMConvBlock(channels, channels, dense_table_cap=dense_table_cap,
                                   generator=generator)
        self.conv1 = SubMConvBlock(channels, channels, use_act=False,
                                   dense_table_cap=dense_table_cap, generator=generator)

    def forward(self, st: sc.SparseTensor, rulebook=None):
        if rulebook is None:
            rulebook = sc.build_subm_rulebook(st, 3, self.dense_table_cap)
        out = self.conv1(self.conv0(st, rulebook), rulebook)
        f = torch.relu(out.features + st.features)
        return out._replace(features=sc._mask_features(f, out.valid))
