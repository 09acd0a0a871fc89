"""Batch norms and sparse conv blocks (counterpart of
pcseqlearning_tpu.models.layers).

The batch norms are written out rather than taken from ``torch.nn``: as in
the JAX modules, the running variance follows the *biased* batch variance
(torch's BatchNorm keeps the unbiased one), ``MaskedBatchNorm`` leaves the
padding rows out of the moments, and the momentum convention is torch's
(new = (1 - m) * old + m * batch) with m = 0.01 and eps = 1e-3, the
reference's spconv norm settings. Training mode is ``module.training``.
Cross-replica moments (the JAX ``bn_cross_replica``) wait for the
data-parallel train step.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import sparse_conv as sc

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
            n = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(0) / n
            var = (w * (x - mean[None, :]) ** 2).sum(0) / n
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean[None, :]) * torch.rsqrt(var[None, :] + self.eps)
        y = y * self.weight[None, :] + self.bias[None, :]
        return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


class BatchNorm2d(_BatchNorm):
    """Batch norm over an NCHW map, moments over (N, H, W)."""

    def forward(self, x):
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            mean = x.sum((0, 2, 3)) / n
            var = ((x - mean[None, :, None, None]) ** 2).sum((0, 2, 3)) / n
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
