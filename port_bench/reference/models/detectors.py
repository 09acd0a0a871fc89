"""The detectors of the benchmark's configurations, CenterPoint and
PV-RCNN: vfe -> backbone_3d -> map_to_bev -> (pfe) -> backbone_2d ->
dense_head, then for PV-RCNN the RoI stage. A frozen copy of the port's
plain model code, cut to these two models."""

from __future__ import annotations

import torch
from torch import nn

from . import roi_heads as rh
from .backbones_2d import BaseBEVBackbone, HeightCompression
from .backbones_3d import BACKBONES_3D
from .dense_heads import AnchorHeadSingle, CenterHead
from .pfe import VoxelSetAbstraction
from .vfe import DynamicMeanVFE


def _conv_out_depth(nz):
    """Depth of the 3D backbones' output for an nz-cell grid (padded to
    nz + 1; three stride-2 convs of kernel 3, padding 1; then kernel 3,
    stride 2, no padding)."""
    d = nz + 1
    for _ in range(3):
        d = (d + 2 - 3) // 2 + 1
    return (d - 3) // 2 + 1


class HeadWrap(nn.Module):
    """The dense head under the name ``head``."""

    def __init__(self, head):
        super().__init__()
        self.head = head

    def forward(self, batch_dict):
        return self.head(batch_dict)

    def loss(self, batch_dict):
        return self.head.loss(batch_dict)

    def generate_predicted_boxes(self, batch_dict):
        return self.head.generate_predicted_boxes(batch_dict)


def _anchor_cfgs(head_cfg):
    return [dict(sizes=[tuple(s) for s in a["anchor_sizes"]],
                 rotations=tuple(a["anchor_rotations"]), heights=tuple(a["anchor_bottom_heights"]),
                 matched_threshold=float(a["matched_threshold"]),
                 unmatched_threshold=float(a["unmatched_threshold"]))
            for a in head_cfg.get("ANCHOR_GENERATOR_CONFIG", [])]


class Detector(nn.Module):
    """CenterPoint or PV-RCNN from the composed MODEL config. In training
    mode the forward puts the losses in ``batch_dict["losses"]``."""

    def __init__(self, cfg, num_classes, grid_size, point_cloud_range, voxel_size, voxel_cap,
                 num_point_features):
        super().__init__()
        self.vfe = DynamicMeanVFE(voxel_size, point_cloud_range, voxel_cap)
        self.backbone_3d = BACKBONES_3D[cfg["BACKBONE_3D"]["NAME"]](
            num_point_features, grid_size, voxel_cap, generator=None)
        bev_channels = self.backbone_3d.conv_out.weight.shape[-1] * _conv_out_depth(grid_size[2])
        self.map_to_bev = HeightCompression()
        self.pfe = self.roi_head = None
        if "PFE" in cfg:
            self.pfe = VoxelSetAbstraction(
                voxel_size, point_cloud_range,
                num_keypoints=int(cfg["PFE"].get("NUM_KEYPOINTS", 2048)),
                source_channels={"x_conv3": self.backbone_3d.channels[3],
                                 "x_conv4": self.backbone_3d.channels[4]},
                raw_channels=num_point_features - 3, bev_channels=bev_channels, aggregation="sa")
        b2d = cfg["BACKBONE_2D"]
        self.backbone_2d = BaseBEVBackbone(
            bev_channels, layer_nums=b2d["LAYER_NUMS"], layer_strides=b2d["LAYER_STRIDES"],
            num_filters=b2d["NUM_FILTERS"], upsample_strides=b2d["UPSAMPLE_STRIDES"],
            num_upsample_filters=b2d["NUM_UPSAMPLE_FILTERS"])
        if "ROI_HEAD" in cfg:
            rcfg = cfg["ROI_HEAD"]
            if rcfg["NAME"] != "PVRCNNHead":
                raise KeyError(rcfg["NAME"])
            self.roi_head = rh.PVRCNNHead(self.pfe.out_channels,
                                          grid_size=int(rcfg.get("GRID_SIZE", 6)))
            self.num_rois = int(rcfg.get("NMS_POST_MAXSIZE", 128))
        head = cfg["DENSE_HEAD"]
        stride = int(head.get("FEATURE_MAP_STRIDE", 8))
        if head["NAME"] == "CenterHead":
            self.dense_head = HeadWrap(CenterHead(
                input_channels=self.backbone_2d.num_bev_features, num_classes=num_classes,
                grid_size_xy=(grid_size[0], grid_size[1]), point_cloud_range=point_cloud_range,
                feature_stride=stride))
        elif head["NAME"] == "AnchorHeadSingle":
            self.dense_head = HeadWrap(AnchorHeadSingle(
                self.backbone_2d.num_bev_features, num_classes,
                (-(-grid_size[0] // stride), -(-grid_size[1] // stride)),
                point_cloud_range, _anchor_cfgs(head)))
        else:
            raise KeyError(head["NAME"])

    def forward(self, batch_dict):
        """The VFE computes its cells in the points' dtype; what it returns
        goes on in the network's (the dense head's parameters')."""
        dtype = next(self.dense_head.parameters()).dtype
        if self.vfe is not None:
            batch_dict = self.vfe(batch_dict)
        batch_dict = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                      for k, v in batch_dict.items()}
        for module in (self.backbone_3d, self.map_to_bev, self.pfe, self.backbone_2d,
                       self.dense_head):
            if module is not None:
                batch_dict = module(batch_dict)
        if self.training:
            batch_dict["losses"] = self.dense_head.loss(batch_dict)
        if self.roi_head is not None:
            batch_dict = self._run_roi_stage(batch_dict)
        return batch_dict

    def _run_roi_stage(self, batch_dict):
        """Per sample, the dense head's boxes through ``proposal_layer``;
        the RoI head over the flattened RoI table; in training, the RoI
        targets and losses (``total_loss`` = the dense head's loss + both
        RoI losses), else the refined boxes and their scores."""
        if "center_preds" in batch_dict:
            boxes, scores, _, _ = self.dense_head.generate_predicted_boxes(batch_dict)
        else:
            boxes, cls_scores = self.dense_head.generate_predicted_boxes(batch_dict)
            scores = cls_scores.amax(dim=-1)
        per_sample = [rh.proposal_layer(boxes[b], scores[b], num_rois=self.num_rois)
                      for b in range(boxes.shape[0])]
        rois, roi_scores, roi_valid = (torch.stack(t) for t in zip(*per_sample))
        B, R = rois.shape[0], rois.shape[1]
        valid_flat = roi_valid.reshape(B * R)
        batch_dict["roi_batch"] = torch.arange(B, device=rois.device).repeat_interleave(R)
        cls_p, reg_p = self.roi_head(batch_dict, rois.reshape(B * R, 7), valid_flat)
        batch_dict.update(rois=rois, roi_scores=roi_scores, roi_valid=roi_valid,
                          rcnn_cls=cls_p.reshape(B, R), rcnn_reg=reg_p.reshape(B, R, -1))
        if self.training:
            gt = batch_dict["gt_boxes"]
            targets = [rh.assign_roi_targets(rois[b], roi_valid[b], gt[b, :, :7],
                                             gt[b, :, 7].to(torch.int64), gt[b, :, 7] > 0)
                       for b in range(B)]
            cls_t, reg_t, fg = (torch.stack([t[i] for t in targets]) for i in range(3))
            cls_l, reg_l = rh.roi_head_loss(cls_p, reg_p, cls_t.reshape(-1),
                                            reg_t.reshape(B * R, -1), fg.reshape(-1), valid_flat)
            losses = dict(batch_dict.get("losses", {}))
            base = "center_loss" if "center_preds" in batch_dict else "rpn_loss"
            losses.update(rcnn_loss_cls=cls_l, rcnn_loss_reg=reg_l,
                          total_loss=losses[base] + cls_l + reg_l)
            batch_dict["losses"] = losses
        else:
            batch_dict["refined_boxes"] = torch.stack([
                rh.decode_roi_boxes(rois[b], batch_dict["rcnn_reg"][b]) for b in range(B)])
            batch_dict["refined_scores"] = torch.sigmoid(batch_dict["rcnn_cls"])
        return batch_dict
