"""Detector assembly (counterpart of pcseqlearning_tpu.models.detectors):
the config-driven module stack vfe -> backbone_3d -> map_to_bev -> pfe ->
backbone_2d -> dense_head (-> seg_head), then, for a two-stage model, the
RoI stage. A point-based model (PointRCNN: its DENSE_HEAD is PointHeadBox)
has no VFE and no BEV path: PointNet2MSG, the point head, the RoI stage.
It builds CenterPoint (with SST for SST-CenterPoint), SECONDNet,
SECONDNetIoU, PointPillar, VoxelRCNN, PartA2Net, PVRCNN, PVRCNNPlusPlus,
PVRCNNPlusPlusCoTrain, PointRCNN and CaDDN as their configs name their
modules, and the JAX package's model zoo that no config names: the VFEs
DynamicVFE, PlaneFitting / HybridVFE, RepsurfDynamicVFE and TemporalVFE,
and the point backbones KPConv / KPConvNet and the GraphConvNet variants
(PointConvNet, VolumeConvNet, PointGroupNet, PointPlaneNet,
PointNet2RepSurf), each built with its defaults, as in JAX. A name neither
package has raises KeyError, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import boxes as box_ops
from ..ops import sparse_conv as sc
from ..ops.sampling import top_k
from ..utils.profiler import span
from . import roi_heads as rh
from .backbones_2d import BaseBEVBackbone, HeightCompression, PointPillarScatter
from .backbones_3d import BACKBONES_3D
from .backbones_graph import VARIANTS as GRAPH_VARIANTS
from .backbones_graph import GraphConvNet
from .backbones_kpconv import KPConvNet
from .backbones_point import PointHeadBox, PointHeadSimple, PointNet2MSG
from .backbones_sst import SSTBackbone
from .backbones_unet import UNetV2, stage4_depth
from .dense_heads import AnchorHeadSingle, CenterHead
from .model_nms_utils import argsort_desc
from .pfe import VoxelSetAbstraction
from .vfe import ZOO_VFES, DynamicMeanVFE, DynPillarVFE, ImageVFE, PlaneFittingVFE, TemporalVFE


def _conv_out_depth(nz):
    """Depth of the 3D backbones' output for an nz-cell grid (padded to
    nz + 1; three stride-2 convs of kernel 3, padding 1; then kernel 3,
    stride 2, no padding)."""
    d = nz + 1
    for _ in range(3):
        d = (d + 2 - 3) // 2 + 1
    return (d - 3) // 2 + 1


class HeadWrap(nn.Module):
    """The detector's dense head under the name ``head``, as in the JAX
    module tree (CenterHeadWrap, AnchorHeadWrap)."""

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


class Detector3DTemplate(nn.Module):
    """Config-driven detector. In training mode the forward also puts the
    losses in ``batch_dict["losses"]``: the dense head's (``point_loss`` for
    a point-based model, plus CaDDN's ``depth_loss``), and with a ROI_HEAD
    the RoI head's and their sum ``total_loss``."""

    def __init__(self, model_cfg, num_classes, grid_size, point_cloud_range, voxel_size,
                 voxel_cap=16384, dense_table_cap=sc.DENSE_TABLE_CAP, generator=None,
                 num_point_features=4):
        super().__init__()
        cfg = model_cfg
        name = str(cfg.get("NAME", ""))
        self.is_point_based = cfg["DENSE_HEAD"]["NAME"] == "PointHeadBox"
        self.vfe = None
        bev_channels = num_point_features  # the VFE's width, for a pillar scatter
        if "VFE" in cfg:
            vfe_cfg = cfg["VFE"]
            vfe_name = vfe_cfg.get("NAME")
            if vfe_name in ("DynamicMeanVFE", "MeanVFE"):
                self.vfe = DynamicMeanVFE(voxel_size, point_cloud_range, voxel_cap)
            elif vfe_name in ("DynPillarVFE", "DynamicPillarVFE"):
                self.vfe = DynPillarVFE(voxel_size, point_cloud_range, voxel_cap,
                                        num_filters=tuple(vfe_cfg.get("NUM_FILTERS", [64])),
                                        num_point_features=num_point_features,
                                        generator=generator)
                bev_channels = self.vfe.out_channels
            elif vfe_name == "ImageVFE":  # built with its defaults, as in JAX
                self.vfe = ImageVFE(voxel_size, point_cloud_range, voxel_cap, generator=generator)
                bev_channels = self.vfe.out_channels
            elif vfe_name in ZOO_VFES:  # the model zoo's, with their defaults, as in JAX
                cls = ZOO_VFES[vfe_name]
                if cls is TemporalVFE:  # writes no voxel table: the 3D backbone raises
                    self.vfe = cls(voxel_size, point_cloud_range, voxel_cap)
                elif cls is PlaneFittingVFE:
                    self.vfe = cls(voxel_size, point_cloud_range, voxel_cap,
                                   num_point_features=num_point_features)
                else:
                    self.vfe = cls(voxel_size, point_cloud_range, voxel_cap,
                                   num_point_features=num_point_features, generator=generator)
                bev_channels = getattr(self.vfe, "out_channels", num_point_features)
            else:
                raise KeyError(vfe_name)
        voxel_width = bev_channels  # the voxel table's width, the 3D backbone's input
        self.backbone_3d = None
        sparse_3d = False  # the dense head's default stride is 8 after a sparse backbone
        if "BACKBONE_3D" in cfg:
            b3d = cfg["BACKBONE_3D"]
            b3d_name = b3d.get("NAME")
            kw = dict(dense_table_cap=dense_table_cap, generator=generator)
            sparse_3d = b3d_name == "UNetV2" or b3d_name in BACKBONES_3D
            if b3d_name == "UNetV2":  # no conv_out: x_conv4 goes to the BEV
                self.backbone_3d = UNetV2(voxel_width, grid_size, voxel_cap, **kw)
                bev_channels = self.backbone_3d.channels[4] * stage4_depth(grid_size[2])
            elif b3d_name in BACKBONES_3D:
                self.backbone_3d = BACKBONES_3D[b3d_name](voxel_width, grid_size,
                                                          voxel_cap, **kw)
                bev_channels = (self.backbone_3d.conv_out.weight.shape[-1]
                                * _conv_out_depth(grid_size[2]))
            elif b3d_name in ("SST", "SSTBackbone"):  # stays a pillar table
                self.backbone_3d = SSTBackbone(
                    bev_channels, dim=int(b3d.get("DIM", 128)),
                    num_blocks=int(b3d.get("NUM_BLOCKS", 4)),
                    window_size=int(b3d.get("WINDOW_SIZE", 12)),
                    grid_size=(grid_size[0], grid_size[1]),
                    num_windows_cap=int(b3d.get("NUM_WINDOWS_CAP", 2048)),
                    window_cap=int(b3d.get("WINDOW_CAP", 144)), generator=generator)
                bev_channels = self.backbone_3d.out_channels
            elif b3d_name in ("PointNet2MSG", "PointNet2Backbone"):  # with its defaults
                self.backbone_3d = PointNet2MSG(num_point_features - 3, generator=generator)
            elif b3d_name in ("KPConv", "KPConvNet"):  # with its defaults
                self.backbone_3d = KPConvNet(num_point_features - 3, generator=generator)
            elif b3d_name in GRAPH_VARIANTS:  # with its defaults
                self.backbone_3d = GraphConvNet(num_point_features - 3, variant=b3d_name,
                                                generator=generator)
            else:
                raise KeyError(b3d_name)
        # a point-based model has no BEV path
        self.map_to_bev = self.backbone_2d = self.pfe = self.seg_head = None
        if not self.is_point_based:
            m2b = cfg.get("MAP_TO_BEV", {"NAME": "HeightCompression"})["NAME"]
            if m2b == "HeightCompression":
                self.map_to_bev = HeightCompression()
            elif m2b == "PointPillarScatter":
                self.map_to_bev = PointPillarScatter(grid_size)
            else:
                raise KeyError(m2b)
            # PV-RCNN's keypoint branch, between the BEV map and the 2D backbone;
            # a PlusPlus model aggregates by vector pooling unless the config says
            if "PFE" in cfg:
                pfe_cfg = cfg["PFE"]
                self.pfe = VoxelSetAbstraction(
                    voxel_size, point_cloud_range,
                    num_keypoints=int(pfe_cfg.get("NUM_KEYPOINTS", 2048)),
                    source_channels={"x_conv3": self.backbone_3d.channels[3],
                                     "x_conv4": self.backbone_3d.channels[4]},
                    raw_channels=num_point_features - 3, bev_channels=bev_channels,
                    aggregation=str(pfe_cfg.get("AGGREGATION",
                                                "vector_pool" if "PlusPlus" in name else "sa")),
                    generator=generator)
            b2d = cfg.get("BACKBONE_2D", {"NAME": "BaseBEVBackbone"})
            self.backbone_2d = BaseBEVBackbone(
                bev_channels,
                layer_nums=b2d.get("LAYER_NUMS", [5, 5]),
                layer_strides=b2d.get("LAYER_STRIDES", [1, 2]),
                num_filters=b2d.get("NUM_FILTERS", [128, 256]),
                upsample_strides=b2d.get("UPSAMPLE_STRIDES", [1, 2]),
                num_upsample_filters=b2d.get("NUM_UPSAMPLE_FILTERS", [256, 256]),
                generator=generator)
            # the co-train's segmentation head over the keypoints: PointHeadSimple
            # whatever SEG_HEAD names, as in JAX
            if "SEG_HEAD" in cfg or "CoTrain" in name:
                self.seg_head = PointHeadSimple(self.pfe.out_channels, num_classes,
                                                generator=generator)
        self.roi_head = None
        if "ROI_HEAD" in cfg:
            rcfg = cfg["ROI_HEAD"]
            rname = rcfg["NAME"]
            grid = int(rcfg.get("GRID_SIZE", 6))
            if rname == "VoxelRCNNHead":  # pools x_conv3 and x_conv4
                self.roi_head = rh.VoxelRCNNHead(
                    voxel_size, point_cloud_range, source_channels=self.backbone_3d.channels[3:5],
                    grid_size=grid, generator=generator)
            elif rname == "PVRCNNHead":  # pools the PFE's keypoints
                self.roi_head = rh.PVRCNNHead(self.pfe.out_channels, grid_size=grid,
                                              generator=generator)
            elif rname == "PointRCNNHead":  # pools the PointNet++ point features
                self.roi_head = rh.PointRCNNHead(self.backbone_3d.out_channels,
                                                 generator=generator)
            elif rname in rh.ROI_HEADS:  # RoI-aware pooling of the raw point features,
                # at the head's own grid (JAX builds it with its defaults)
                self.roi_head = rh.ROI_HEADS[rname](num_point_features - 3, generator=generator)
            else:
                raise KeyError(rname)
            self.num_rois = int(rcfg.get("NMS_POST_MAXSIZE", 128))
        head = cfg["DENSE_HEAD"]
        stride = int(head.get("FEATURE_MAP_STRIDE", 8 if sparse_3d else 1))
        if self.is_point_based:
            self.dense_head = PointHeadBox(self.backbone_3d.out_channels, num_classes,
                                           generator=generator)
        elif head["NAME"] == "CenterHead":
            self.dense_head = HeadWrap(CenterHead(
                input_channels=self.backbone_2d.num_bev_features, num_classes=num_classes,
                grid_size_xy=(grid_size[0], grid_size[1]), point_cloud_range=point_cloud_range,
                feature_stride=stride, generator=generator))
        elif head["NAME"] == "AnchorHeadSingle":
            self.dense_head = HeadWrap(AnchorHeadSingle(
                self.backbone_2d.num_bev_features, num_classes,
                (-(-grid_size[0] // stride), -(-grid_size[1] // stride)),
                point_cloud_range, _anchor_cfgs(head), predict_iou=name == "SECONDNetIoU",
                generator=generator))
        else:
            raise KeyError(head["NAME"])

    def forward(self, batch_dict):
        """The VFE computes its cells in the points' dtype; what it returns
        (the batch itself for a model without a VFE) goes on in the
        network's (the dense head's parameters'). CaDDN's depth loss and the
        co-train's segmentation loss (``seg_loss``) add to the dense head's
        loss, and so to ``total_loss``. Each module runs in a
        ``utils.profiler`` span of its attribute's name, the dense head's
        loss in ``dense_head.loss`` and the RoI stage in ``roi_stage``."""
        dtype = next(self.dense_head.parameters()).dtype
        if self.vfe is not None:
            with span("vfe"):
                batch_dict = self.vfe(batch_dict)
        batch_dict = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                      for k, v in batch_dict.items()}
        for name in ("backbone_3d", "map_to_bev", "pfe", "backbone_2d", "dense_head"):
            module = getattr(self, name)
            if module is not None:
                with span(name):
                    batch_dict = module(batch_dict)
        if self.training:
            with span("dense_head.loss"):
                if self.is_point_based:
                    losses = PointHeadBox.loss(batch_dict, batch_dict["gt_boxes"])
                else:
                    losses = self.dense_head.loss(batch_dict)
                if isinstance(self.vfe, ImageVFE):
                    losses = self._add_to_base(losses, "depth_loss",
                                               self.vfe.depth_loss(batch_dict))
            batch_dict["losses"] = losses
        if self.seg_head is not None:
            batch_dict = self.seg_head(batch_dict)
            if self.training:
                seg = PointHeadSimple.loss(batch_dict, batch_dict["gt_boxes"])
                batch_dict["losses"] = self._add_to_base(batch_dict["losses"], "seg_loss", seg)
        if self.roi_head is not None:
            with span("roi_stage"):
                batch_dict = self._run_roi_stage(batch_dict)
        return batch_dict

    @staticmethod
    def _add_to_base(losses, key, value):
        """``losses`` with ``key`` set to ``value``, added to center_loss or
        rpn_loss (whichever the dense head gave)."""
        losses = dict(losses, **{key: value})
        base = "center_loss" if "center_loss" in losses else "rpn_loss"
        if base in losses:
            losses[base] = losses[base] + value
        return losses

    def _run_roi_stage(self, batch_dict):
        """Per sample, the dense head's boxes through ``proposal_layer``;
        the RoI head over the flattened RoI table; in training, the RoI
        targets and losses (``total_loss`` = the dense head's loss + both
        RoI losses), else the refined boxes and their scores."""
        if self.is_point_based:  # every point's box; scores -inf outside their sample
            flat_boxes, flat_scores, _ = PointHeadBox.generate_predicted_boxes(batch_dict)
            batch_dict["point_cls_scores"] = flat_scores
            bidx = torch.round(batch_dict["point_coords"][:, 0]).long()
            nb = int(batch_dict.get("batch_size", 1))
            boxes = flat_boxes[None].expand(nb, *flat_boxes.shape)
            scores = torch.where(bidx[None, :] == torch.arange(nb, device=bidx.device)[:, None],
                                 flat_scores[None, :],
                                 torch.full((), float("-inf"), dtype=flat_scores.dtype,
                                            device=flat_scores.device))
        elif "center_preds" in batch_dict:
            boxes, scores, _, _ = self.dense_head.generate_predicted_boxes(batch_dict)
        else:
            boxes, cls_scores = self.dense_head.generate_predicted_boxes(batch_dict)
            scores = cls_scores.amax(dim=-1)
        with span("roi_stage.proposal"):
            per_sample = [rh.proposal_layer(boxes[b], scores[b], num_rois=self.num_rois)
                          for b in range(boxes.shape[0])]
        rois, roi_scores, roi_valid = (torch.stack(t) for t in zip(*per_sample))
        if self.is_point_based:
            roi_valid = roi_valid & torch.isfinite(roi_scores)
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
            base = ("point_loss" if self.is_point_based else
                    "center_loss" if "center_preds" in batch_dict else "rpn_loss")
            losses.update(rcnn_loss_cls=cls_l, rcnn_loss_reg=reg_l,
                          total_loss=losses[base] + cls_l + reg_l)
            batch_dict["losses"] = losses
        else:
            batch_dict["refined_boxes"] = torch.stack([
                rh.decode_roi_boxes(rois[b], batch_dict["rcnn_reg"][b]) for b in range(B)])
            batch_dict["refined_scores"] = torch.sigmoid(batch_dict["rcnn_cls"])
        return batch_dict

    @torch.no_grad()
    def predict(self, batch_dict):
        """The eval-mode forward and its decoded predictions: (batch_dict,
        boxes [B, K, 7], scores [B, K], labels [B, K], valid [B, K]): the
        refined RoIs (label 1) for a two-stage model, the CenterHead's top-K
        decode, or the anchor head's boxes through ``post_process_anchor``.
        The module's mode is restored afterwards."""
        was_training = self.training
        self.eval()
        try:
            out = self(batch_dict)
        finally:
            self.train(was_training)
        if self.roi_head is not None:
            scores = out["refined_scores"]
            return (out, out["refined_boxes"], scores, torch.ones_like(scores, dtype=torch.int64),
                    out["roi_valid"])
        if "center_preds" in out:
            return (out,) + tuple(self.dense_head.generate_predicted_boxes(out))
        raw_boxes, raw_scores = self.dense_head.generate_predicted_boxes(out)
        per_sample = [post_process_anchor(raw_boxes[b], raw_scores[b])
                      for b in range(raw_boxes.shape[0])]
        return (out,) + tuple(torch.stack(t) for t in zip(*per_sample))


def post_process_anchor(boxes, scores, nms_thresh=0.7, score_thresh=0.1, pre_max=4096,
                        post_max=500):
    """One sample's class-agnostic NMS over the anchor head's decoded boxes
    [A, 7] and class scores [A, C], with these defaults (as the JAX package
    runs it, not POST_PROCESSING): the top ``pre_max`` by their best class,
    NMS among those above ``score_thresh``, the kept first. Returns (boxes
    [P, 7], scores [P], labels [P] from 1, valid [P]), P = min(post_max,
    pre_max, A)."""
    cls_score = scores.amax(dim=-1)
    labels = torch.argmax(scores, dim=-1) + 1
    topv, topi = top_k(cls_score, min(pre_max, cls_score.shape[0]))
    cand = boxes[topi]
    keep = box_ops.nms_bev(cand, topv, nms_thresh, valid=topv > score_thresh)
    order = argsort_desc(torch.where(keep, topv, torch.full_like(topv, float("-inf"))))
    order = order[:post_max]
    return cand[order], topv[order], labels[topi][order], keep[order] & (topv[order] > score_thresh)


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
