"""The plain reference of the benchmark's training cells.

A frozen copy of the port's plain model code (the detector cut to
CenterPoint and PV-RCNN, its layers, the sparse convolution over the hash
and dense row tables, the heads, the keypoint branch, the RoI stage, the
losses, the box ops and the clipped AdamW with its schedule), with its
imports made relative to this folder. It imports nothing of the program:
it builds its own network, works out its own voxel tables, rulebooks,
targets, keypoints and RoIs from the benchmark's points and boxes, and is
handed only the benchmark's initial weights.

It runs in the dtype it is given (float64 for the comparison that decides
``correct``; float32 with TF32 on for the control). The voxel cells, the
ball queries and the keypoint picks are made on the float32 points and
boxes, as the data are float32; everything after the voxel table runs in
the network's dtype.
"""

from __future__ import annotations

import torch

from .models.detectors import Detector
from .runtime.optimization import build_optimizer


def build(cfg, dtype, device):
    """The configuration's detector in ``dtype`` on ``device``."""
    data, model = cfg["DATA_CONFIG"], cfg["MODEL"]
    pcr = tuple(float(v) for v in data["POINT_CLOUD_RANGE"])
    vs = tuple(float(v) for v in data["VOXEL_SIZE"])
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    net = Detector(model, len(cfg["CLASS_NAMES"]), grid, pcr, vs, int(model["VOXEL_CAP"]),
                   len(data["POINT_FEATURE_ENCODING"]["used_feature_list"]))
    return net.to(device=device, dtype=dtype)


def optimizer(cfg, params):
    """The configuration's clipped optimizer over ``params``."""
    sched = cfg["schedule"]
    make, _ = build_optimizer(cfg["OPTIMIZATION"], int(sched["iters_per_epoch"]),
                              int(sched["epochs"]))
    return make(params)


def flatten(batch):
    """The dense batch [B, N, .] -> the flat point table with batch indices."""
    points = batch["points"]
    b, n, _ = points.shape
    pts = points.clone()
    pts[:, :, 0] = torch.arange(b, dtype=points.dtype, device=points.device)[:, None]
    return {"point_bxyz": pts.reshape(b * n, 4), "point_feat": batch["feats"].reshape(b * n, -1),
            "point_valid": batch["valid"].reshape(b * n), "gt_boxes": batch["gt_boxes"],
            "batch_size": b}


def loss_key(model_cfg):
    """The loss a step differentiates."""
    if "ROI_HEAD" in model_cfg:
        return "total_loss"
    return "center_loss" if model_cfg["DENSE_HEAD"]["NAME"] == "CenterHead" else "rpn_loss"


def train_step(net, opt, batch, key):
    """One training step: the forward (which updates the batch norms'
    running statistics), the loss's backward, the clipped update. Returns
    its losses by name."""
    net.train()
    out = net(flatten(batch))
    losses = {k: float(v.detach()) for k, v in out["losses"].items()}
    opt.zero_grad()
    out["losses"][key].backward()
    opt.step()
    return losses
