"""Sparse UNet backbone (counterpart of
pcseqlearning_tpu.models.backbones_unet): ``UNetV2``, the VoxelBackBone8x-
style encoder (one subm block a stage) plus a decoder of inverse sparse
convs with concatenated skips, ``InverseConvBlock`` and ``PointSegHead``.

The input grid is (D + 1, H, W) for a (W, H, D) ``grid_size``. Stage
capacities follow the JAX module: the input cap V for stages 1-2, V/2 for
stage 3, V/4 for stage 4. A decoder stage lands on an encoder stage's
coordinates, so its merge conv shares that stage's rulebook.
"""

from __future__ import annotations


import torch
from torch import nn

from ..ops import sparse_conv as sc
from .layers import MaskedBatchNorm, SparseConvBlock, SubMConvBlock, _finish, _sparse_weight
from .vfe import linear


class InverseConvBlock(nn.Module):
    """SparseInverseConv3d + BN + ReLU onto known finer coords."""

    def __init__(self, cin, cout, kernel_size=3, stride=2, padding=1,
                 dense_table_cap=sc.DENSE_TABLE_CAP, generator=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dense_table_cap = dense_table_cap
        self.weight = _sparse_weight(kernel_size, cin, cout, generator)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, st: sc.SparseTensor, target: sc.SparseTensor):
        out = sc.sparse_inverse_conv3d(st, target, self.weight, kernel_size=self.kernel_size,
                                       stride=self.stride, padding=self.padding,
                                       dense_table_cap=self.dense_table_cap)
        return _finish(out, self.bn, True)


class UNetV2(nn.Module):
    """conv_input, conv1 (stride 1), then down2-down4 (strided) each with
    one subm block (conv2-conv4); the decoder up3 / merge3, up2 / merge2,
    up1 / merge1 (inverse conv onto the skip's coords, concatenated with
    the skip, subm conv). Writes ``encoded_spconv_tensor`` = x_conv4
    (stride 8: UNetV2 has no conv_out), ``multi_scale_3d_features``,
    ``voxel_point_features`` and ``unet_out`` (the decoder's output)."""

    def __init__(self, input_channels, grid_size, voxel_cap, channels=(16, 16, 32, 64, 64),
                 dense_table_cap=sc.DENSE_TABLE_CAP, generator=None):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_cap = int(voxel_cap)
        self.dense_table_cap = dense_table_cap
        self.channels = c = tuple(channels)
        kw = dict(dense_table_cap=dense_table_cap, generator=generator)
        cap = self.voxel_cap
        self.conv_input = SubMConvBlock(input_channels, c[0], **kw)
        self.conv1 = SubMConvBlock(c[0], c[1], **kw)
        for s, out_cap in ((2, cap), (3, max(cap // 2, 1)), (4, max(cap // 4, 1))):
            setattr(self, f"down{s}", SparseConvBlock(c[s - 1], c[s], out_cap=out_cap, **kw))
            setattr(self, f"conv{s}", SubMConvBlock(c[s], c[s], **kw))
        for s, (cin, cskip) in ((3, (c[4], c[3])), (2, (c[3], c[2])), (1, (c[2], c[1]))):
            setattr(self, f"up{s}", InverseConvBlock(cin, cskip, **kw))
            setattr(self, f"merge{s}", SubMConvBlock(2 * cskip, cskip, **kw))

    def _rulebook(self, st):
        return sc.build_subm_rulebook(st, 3, self.dense_table_cap)

    def forward(self, batch_dict):
        W, H, D = self.grid_size
        st = sc.SparseTensor(batch_dict["voxel_features"], batch_dict["voxel_coords"],
                             batch_dict["voxel_valid"], (D + 1, H, W),
                             int(batch_dict["batch_size"]))
        rbs = {1: self._rulebook(st)}
        x = self.conv_input(st, rbs[1])
        skips = {1: self.conv1(x, rbs[1])}
        x = skips[1]
        for s in (2, 3, 4):
            x = getattr(self, f"down{s}")(x)
            rbs[s] = self._rulebook(x)
            x = getattr(self, f"conv{s}")(x, rbs[s])
            skips[s] = x
        for s in (3, 2, 1):
            u = getattr(self, f"up{s}")(x, skips[s])
            m = u._replace(features=torch.cat([u.features, skips[s].features], dim=-1))
            x = getattr(self, f"merge{s}")(m, rbs[s])
        batch_dict["voxel_point_features"] = x.features
        batch_dict["unet_out"] = x
        batch_dict["encoded_spconv_tensor"] = skips[4]
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = {f"x_conv{s}": skips[s] for s in (1, 2, 3, 4)}
        return batch_dict


def stage4_depth(nz):
    """Depth of UNetV2's x_conv4 for an nz-cell grid (padded to nz + 1;
    three stride-2 convs of kernel 3, padding 1)."""
    d = nz + 1
    for _ in range(3):
        d = (d + 2 - 3) // 2 + 1
    return d


class PointSegHead(nn.Module):
    """Per-voxel segmentation head over UNetV2's ``voxel_point_features``
    (reference dense_heads/point_seg_head.py): per hidden width, linear (no
    bias), ``MaskedBatchNorm`` over the valid voxels and ReLU, then a linear
    to the class logits (``seg_logits``). No config builds it."""

    def __init__(self, cin, num_classes, hidden=(64,), generator=None):
        super().__init__()
        self.num_hidden = len(hidden)
        for i, c in enumerate(hidden):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c
        setattr(self, f"linear{self.num_hidden}",
                linear(cin, num_classes, bias=True, generator=generator))

    def forward(self, batch_dict):
        x, valid = batch_dict["voxel_point_features"], batch_dict["voxel_valid"]
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
        batch_dict["seg_logits"] = getattr(self, f"linear{self.num_hidden}")(x)
        return batch_dict

    @staticmethod
    def loss(batch_dict, labels, valid):
        """Cross-entropy over the valid voxels with a label >= 0 (labels
        clipped into the classes), averaged over them."""
        logits = batch_dict["seg_logits"]
        nc = logits.shape[-1]
        onehot = nn.functional.one_hot(torch.clamp(labels.long(), 0, nc - 1), nc).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        w = (valid & (labels >= 0)).to(logits.dtype)
        ce = -(onehot * logp).sum(-1) * w
        return ce.sum() / torch.clamp(w.sum(), min=1.0)
