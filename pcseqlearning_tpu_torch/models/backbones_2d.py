"""BEV projection and 2D backbone (counterpart of
pcseqlearning_tpu.models.backbones_2d): ``HeightCompression`` and
``BaseBEVBackbone``. The port's maps are NCHW where the JAX modules' are
NHWC; ``convert.detector_params_from_flax`` maps the kernels.
``PointPillarScatter`` waits for PointPillar (ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import sparse_conv as sc
from .layers import BatchNorm2d, init_fan_in


class HeightCompression(nn.Module):
    """Stack the z slices into channels: the sparse (B, D, H, W, C) table
    becomes a dense [B, D * C, H, W] map, channel d * C + c (the JAX
    module's NHWC channel order)."""

    def forward(self, batch_dict):
        dense = sc.to_dense(batch_dict["encoded_spconv_tensor"])  # [B, D, H, W, C]
        b, d, h, w, c = dense.shape
        batch_dict["spatial_features"] = dense.permute(0, 1, 4, 2, 3).reshape(b, d * c, h, w)
        batch_dict["spatial_features_stride"] = batch_dict.get("encoded_spconv_tensor_stride", 8)
        return batch_dict


def conv2d(cin, cout, k, stride=1, padding=0, bias=False, generator=None):
    """nn.Conv2d initialised as flax's nn.Conv (lecun_normal, zero bias)."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
    init_fan_in(conv.weight, cin * k * k, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class BaseBEVBackbone(nn.Module):
    """Multi-scale conv blocks, each upsampled (a transposed conv for a
    stride above 1, else a 1x1 conv) and concatenated."""

    def __init__(self, input_channels, layer_nums=(5, 5), layer_strides=(1, 2),
                 num_filters=(128, 256), upsample_strides=(1, 2),
                 num_upsample_filters=(256, 256), generator=None):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(int(u) for u in upsample_strides)
        cin = input_channels
        for i, n_layers in enumerate(self.layer_nums):
            f = num_filters[i]
            setattr(self, f"block{i}_down", conv2d(cin, f, 3, layer_strides[i], 1,
                                                   generator=generator))
            setattr(self, f"block{i}_down_bn", BatchNorm2d(f))
            for j in range(n_layers):
                setattr(self, f"block{i}_conv{j}", conv2d(f, f, 3, 1, 1, generator=generator))
                setattr(self, f"block{i}_bn{j}", BatchNorm2d(f))
            u, fu = self.upsample_strides[i], num_upsample_filters[i]
            if u > 1:
                de = nn.ConvTranspose2d(f, fu, u, stride=u, bias=False)
                # flax's ConvTranspose kernel is (u, u, in, out): fan-in u * u * in
                init_fan_in(de.weight, f * u * u, generator)
            else:
                de = conv2d(f, fu, 1, generator=generator)
            setattr(self, f"deblock{i}", de)
            setattr(self, f"deblock{i}_bn", BatchNorm2d(fu))
            cin = f
        self.num_bev_features = sum(num_upsample_filters[:len(self.layer_nums)])

    def forward(self, batch_dict):
        x = batch_dict["spatial_features"]
        ups = []
        for i, n_layers in enumerate(self.layer_nums):
            x = torch.relu(getattr(self, f"block{i}_down_bn")(getattr(self, f"block{i}_down")(x)))
            for j in range(n_layers):
                x = torch.relu(getattr(self, f"block{i}_bn{j}")(getattr(self, f"block{i}_conv{j}")(x)))
            y = getattr(self, f"deblock{i}")(x)
            ups.append(torch.relu(getattr(self, f"deblock{i}_bn")(y)))
        batch_dict["spatial_features_2d"] = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return batch_dict
