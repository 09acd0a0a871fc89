"""CenterNet losses (counterpart of the CenterHead's part of
pcseqlearning_tpu.utils.loss_utils). The rest of the file waits for the
heads that use it (ROADMAP.md, queue 1 item 4)."""

from __future__ import annotations

import torch


def focal_loss_centernet(pred_sigmoid, gt_heatmap, eps=1e-4):
    """Penalty-reduced pixelwise focal loss (CornerNet / CenterNet form), a
    scalar over the number of positives."""
    pred = torch.clamp(pred_sigmoid, eps, 1.0 - eps)
    pos = gt_heatmap == 1.0
    neg_weights = torch.pow(1.0 - gt_heatmap, 4.0)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_weights * (~pos)
    num_pos = pos.to(pred.dtype).sum()
    loss = -(pos_loss.sum() + neg_loss.sum())
    return torch.where(num_pos > 0, loss / torch.clamp(num_pos, min=1.0), -neg_loss.sum())


def reg_loss_centernet(pred, target, mask):
    """Masked L1 of the regression targets at the GT centres, per channel:
    pred / target [B, K, C], mask [B, K]."""
    w = mask.to(pred.dtype)[..., None]
    return (torch.abs(pred - target) * w).sum((0, 1)) / torch.clamp(w.sum(), min=1.0)
