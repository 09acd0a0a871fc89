"""Detector assembly (counterpart of pcseqlearning_tpu.models.detectors):
the config-driven module stack vfe -> backbone_3d -> map_to_bev ->
backbone_2d -> dense_head, with the modules CenterPoint runs. Every other
module name of the JAX package raises NotImplementedError naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import sparse_conv as sc
from .backbones_2d import BaseBEVBackbone, HeightCompression, PointPillarScatter
from .backbones_3d import BACKBONES_3D
from .dense_heads import CenterHead
from .vfe import DynamicMeanVFE

_LATER = "ROADMAP.md, queue 1 item 4 (the other detectors)"


def _unported(what):
    return NotImplementedError(f"{what} is not ported yet ({_LATER})")


def _conv_out_depth(nz):
    """Depth of the 3D backbones' output for an nz-cell grid (padded to
    nz + 1; three stride-2 convs of kernel 3, padding 1; then kernel 3,
    stride 2, no padding)."""
    d = nz + 1
    for _ in range(3):
        d = (d + 2 - 3) // 2 + 1
    return (d - 3) // 2 + 1


class CenterHeadWrap(nn.Module):
    """The detector's dense head: a ``CenterHead`` under the name ``head``,
    as in the JAX module tree."""

    def __init__(self, **kw):
        super().__init__()
        self.head = CenterHead(**kw)

    def forward(self, batch_dict):
        return self.head(batch_dict)

    def loss(self, batch_dict):
        return self.head.loss(batch_dict)

    def generate_predicted_boxes(self, batch_dict):
        return self.head.generate_predicted_boxes(batch_dict)


class Detector3DTemplate(nn.Module):
    """Config-driven detector. In training mode the forward also puts the
    head's losses in ``batch_dict["losses"]``."""

    def __init__(self, model_cfg, num_classes, grid_size, point_cloud_range, voxel_size,
                 voxel_cap=16384, dense_table_cap=sc.DENSE_TABLE_CAP, generator=None,
                 num_point_features=4):
        super().__init__()
        cfg = model_cfg
        for key in ("PFE", "ROI_HEAD", "SEG_HEAD"):
            if key in cfg:
                raise _unported(f"{key} {cfg[key].get('NAME')!r}")
        if "CoTrain" in str(cfg.get("NAME", "")):
            raise _unported(f"the detector {cfg['NAME']!r}")
        vfe_name = cfg.get("VFE", {}).get("NAME")
        if vfe_name not in ("DynamicMeanVFE", "MeanVFE"):
            raise _unported(f"the VFE {vfe_name!r}")
        self.vfe = DynamicMeanVFE(voxel_size, point_cloud_range, voxel_cap)
        self.backbone_3d = None
        bev_channels = num_point_features  # the VFE's width, for a pillar scatter
        if "BACKBONE_3D" in cfg:
            b3d = cfg["BACKBONE_3D"].get("NAME")
            if b3d not in BACKBONES_3D:
                raise _unported(f"the 3D backbone {b3d!r}")
            self.backbone_3d = BACKBONES_3D[b3d](
                num_point_features, grid_size, voxel_cap,
                dense_table_cap=dense_table_cap, generator=generator)
            bev_channels = (self.backbone_3d.conv_out.weight.shape[-1]
                            * _conv_out_depth(grid_size[2]))
        m2b = cfg.get("MAP_TO_BEV", {"NAME": "HeightCompression"})["NAME"]
        if m2b == "HeightCompression":
            self.map_to_bev = HeightCompression()
        elif m2b == "PointPillarScatter":
            self.map_to_bev = PointPillarScatter(grid_size)
        else:
            raise _unported(f"MAP_TO_BEV {m2b!r}")
        b2d = cfg.get("BACKBONE_2D", {"NAME": "BaseBEVBackbone"})
        self.backbone_2d = BaseBEVBackbone(
            bev_channels,
            layer_nums=b2d.get("LAYER_NUMS", [5, 5]),
            layer_strides=b2d.get("LAYER_STRIDES", [1, 2]),
            num_filters=b2d.get("NUM_FILTERS", [128, 256]),
            upsample_strides=b2d.get("UPSAMPLE_STRIDES", [1, 2]),
            num_upsample_filters=b2d.get("NUM_UPSAMPLE_FILTERS", [256, 256]),
            generator=generator)
        head = cfg["DENSE_HEAD"]
        if head["NAME"] != "CenterHead":
            raise _unported(f"the dense head {head['NAME']!r}")
        self.dense_head = CenterHeadWrap(
            input_channels=self.backbone_2d.num_bev_features, num_classes=num_classes,
            grid_size_xy=(grid_size[0], grid_size[1]), point_cloud_range=point_cloud_range,
            feature_stride=int(head.get("FEATURE_MAP_STRIDE",
                                        1 if self.backbone_3d is None else 8)),
            generator=generator)

    def forward(self, batch_dict):
        for module in (self.vfe, self.backbone_3d, self.map_to_bev, self.backbone_2d,
                       self.dense_head):
            if module is not None:
                batch_dict = module(batch_dict)
        if self.training:
            batch_dict["losses"] = self.dense_head.loss(batch_dict)
        return batch_dict

    @torch.no_grad()
    def predict(self, batch_dict):
        """The eval-mode forward and its decoded predictions: (batch_dict,
        boxes [B, K, 7], scores [B, K], labels [B, K], valid [B, K]). The
        module's mode is restored afterwards."""
        was_training = self.training
        self.eval()
        try:
            out = self(batch_dict)
        finally:
            self.train(was_training)
        return (out,) + tuple(self.dense_head.generate_predicted_boxes(out))


def build_detector(model_cfg, runtime_cfg=None, device="cuda", seed=0):
    """The detector of the composed config on ``device`` (``"cuda"`` raises
    without a card), its initial weights drawn from a torch.Generator
    seeded with ``seed``. ``runtime_cfg`` carries the geometry as the JAX
    function takes it (``data_cfg`` POINT_CLOUD_RANGE and VOXEL_SIZE,
    ``class_names``, ``voxel_cap``), plus ``dense_table_cap`` (default
    300,000,000, the JAX package's PCSEQ_DENSE_TABLE_CAP default) and
    ``num_point_features``, the VFE's width: x, y, z and the point features
    (default 4, one feature; flax infers it from the input)."""
    dev = resolve_device(device)
    runtime_cfg = runtime_cfg or {}
    data_cfg = runtime_cfg.get("data_cfg", {})
    pcr = tuple(data_cfg.get("POINT_CLOUD_RANGE", [-74.88, -74.88, -2, 74.88, 74.88, 4]))
    voxel_size = tuple(data_cfg.get("VOXEL_SIZE", [0.1, 0.1, 0.15]))
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / voxel_size[i])) for i in range(3))
    model = Detector3DTemplate(
        model_cfg,
        num_classes=len(runtime_cfg.get("class_names", ["Vehicle", "Pedestrian", "Cyclist"])),
        grid_size=grid, point_cloud_range=pcr, voxel_size=voxel_size,
        voxel_cap=int(runtime_cfg.get("voxel_cap", 16384)),
        dense_table_cap=int(runtime_cfg.get("dense_table_cap", sc.DENSE_TABLE_CAP)),
        generator=torch.Generator().manual_seed(seed),
        num_point_features=int(runtime_cfg.get("num_point_features", 4)))
    return model.to(dev)
