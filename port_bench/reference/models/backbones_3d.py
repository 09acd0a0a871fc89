"""Sparse voxel backbones (counterpart of
pcseqlearning_tpu.models.backbones_3d): ``VoxelBackBone8x`` and its residual
variant ``VoxelResBackBone8x``, four stages to stride 8 over
``ops.sparse_conv``.

The input grid is (D + 1, H, W) for a (W, H, D) ``grid_size``, as the
reference pads z. Stage capacities follow the JAX modules: the input cap
V for stages 1-2, V/2 for stage 3, V/4 for stage 4 and the output. Every
subm conv of a stage shares the stage's rulebook.
"""

from __future__ import annotations

from torch import nn

from ..ops import sparse_conv as sc
from .layers import SparseBasicBlock, SparseConvBlock, SubMConvBlock


class _Backbone8x(nn.Module):
    def __init__(self, input_channels, grid_size, channels, out_channels, voxel_cap, residual,
                 dense_table_cap=sc.DENSE_TABLE_CAP, generator=None):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_cap = int(voxel_cap)
        self.dense_table_cap = dense_table_cap
        self.residual = residual
        self.channels = c = tuple(channels)  # stage s's output has channels[s]
        kw = dict(dense_table_cap=dense_table_cap, generator=generator)
        cap = self.voxel_cap
        self.conv_input = SubMConvBlock(input_channels, c[0], **kw)
        for s, (cin, cout, out_cap) in enumerate(
                [(c[0], c[1], None), (c[1], c[2], cap), (c[2], c[3], max(cap // 2, 1)),
                 (c[3], c[4], max(cap // 4, 1))], start=1):
            if s > 1:
                setattr(self, f"conv{s}_down", SparseConvBlock(cin, cout, out_cap=out_cap, **kw))
            if residual:
                setattr(self, f"res{s}_a", SparseBasicBlock(cout, **kw))
                setattr(self, f"res{s}_b", SparseBasicBlock(cout, **kw))
            else:
                if s == 1:
                    self.conv1 = SubMConvBlock(c[0], c[1], **kw)
                else:
                    setattr(self, f"conv{s}_a", SubMConvBlock(cout, cout, **kw))
                    setattr(self, f"conv{s}_b", SubMConvBlock(cout, cout, **kw))
        self.conv_out = SparseConvBlock(c[4], out_channels, kernel_size=(3, 1, 1),
                                        stride=(2, 1, 1), padding=0,
                                        out_cap=max(cap // 4, 1), **kw)

    def _rulebook(self, st):
        return sc.build_subm_rulebook(st, 3, self.dense_table_cap)

    def _stage(self, s, x, rb):
        if self.residual:
            x = getattr(self, f"res{s}_a")(x, rb)
            return getattr(self, f"res{s}_b")(x, rb)
        if s == 1:
            return self.conv1(x, rb)
        x = getattr(self, f"conv{s}_a")(x, rb)
        return getattr(self, f"conv{s}_b")(x, rb)

    def forward(self, batch_dict):
        W, H, D = self.grid_size
        feats = batch_dict["voxel_features"]
        st = sc.SparseTensor(feats, batch_dict["voxel_coords"], batch_dict["voxel_valid"],
                             (D + 1, H, W), int(batch_dict["batch_size"]))
        rb = self._rulebook(st)
        x = self.conv_input(st, rb)
        feats = {}
        for s in range(1, 5):
            if s > 1:
                x = getattr(self, f"conv{s}_down")(x)
                rb = self._rulebook(x)
            x = self._stage(s, x, rb)
            feats[f"x_conv{s}"] = x
        batch_dict["encoded_spconv_tensor"] = self.conv_out(x)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = feats
        return batch_dict


class VoxelBackBone8x(_Backbone8x):
    """conv_input -> conv1 (subm) -> conv2..4 (a strided conv and two subm
    convs each) -> conv_out (kernel (3, 1, 1), stride (2, 1, 1))."""

    def __init__(self, input_channels, grid_size, voxel_cap, channels=(16, 16, 32, 64, 64),
                 out_channels=128, **kw):
        super().__init__(input_channels, grid_size, channels, out_channels, voxel_cap,
                         residual=False, **kw)


class VoxelResBackBone8x(_Backbone8x):
    """The residual variant: two SparseBasicBlocks a stage."""

    def __init__(self, input_channels, grid_size, voxel_cap, channels=(16, 16, 32, 64, 128),
                 out_channels=128, **kw):
        super().__init__(input_channels, grid_size, channels, out_channels, voxel_cap,
                         residual=True, **kw)


BACKBONES_3D = {"VoxelBackBone8x": VoxelBackBone8x, "VoxelResBackBone8x": VoxelResBackBone8x}
