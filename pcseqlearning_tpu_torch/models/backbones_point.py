"""Point heads (counterpart of pcseqlearning_tpu.models.backbones_point):
``PointHeadSimple``, the PV-RCNN++ co-train's segmentation head over the
keypoints, and its loss. PointNet2MSG, its SA / FP layers and
PointHeadBox belong to PointRCNN (ROADMAP.md, queue 1 item 4.3).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.boxes import points_in_boxes
from ..utils.loss_utils import sigmoid_focal_cls_loss
from .layers import MaskedBatchNorm
from .vfe import linear


def _point_valid(batch_dict, rows, device):
    valid = batch_dict.get("point_valid")
    if valid is None:
        return torch.ones(rows, dtype=torch.bool, device=device)
    return valid


class PointHeadSimple(nn.Module):
    """Point-wise foreground classification (reference
    point_head_simple.py) over ``point_features``: per hidden width, linear
    (no bias), ``MaskedBatchNorm`` and ReLU, then a linear to the class
    logits (``point_cls_preds``).

    Its mask is ``point_valid`` when the batch has one, as in the JAX
    module: the raw points' mask, over the keypoint rows. Where the two
    lengths do not broadcast (every batch of the train step, which always
    carries ``point_valid``) this raises, as the JAX module does; where they
    do, it computes the JAX module's function."""

    def __init__(self, cin, num_classes, hidden=(256, 256), generator=None):
        super().__init__()
        self.num_hidden = len(hidden)
        for i, c in enumerate(hidden):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c
        setattr(self, f"linear{self.num_hidden}",
                linear(cin, num_classes, bias=True, generator=generator))

    def forward(self, batch_dict):
        x = batch_dict["point_features"]
        valid = _point_valid(batch_dict, x.shape[0], x.device)
        if valid.shape[0] not in (1, x.shape[0]) and x.shape[0] != 1:
            raise ValueError(
                f"PointHeadSimple: point_valid [{valid.shape[0]}] and the point features "
                f"[{x.shape[0]}, {x.shape[1]}] do not broadcast (the JAX module masks the "
                f"keypoint features with the raw points' mask and raises here too)")
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
        batch_dict["point_cls_preds"] = getattr(self, f"linear{self.num_hidden}")(x)
        return batch_dict

    @staticmethod
    def loss(batch_dict, gt_boxes):
        """Sigmoid focal loss against points-in-boxes targets: a point's
        label is the class of the first GT box of its sample (class > 0)
        that holds it, else 0 (background); the weights are the valid
        points over the count of valid foreground points (at least 1)."""
        logits, coords = batch_dict["point_cls_preds"], batch_dict["point_coords"]
        valid = _point_valid(batch_dict, logits.shape[0], logits.device)
        nc = logits.shape[-1]
        bidx = torch.round(coords[:, 0]).long()
        labels = torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device)
        for b in range(gt_boxes.shape[0]):
            cls = gt_boxes[b, :, 7].long()
            bp = points_in_boxes(coords[:, 1:4], gt_boxes[b, :, :7])
            bp = bp & (cls > 0)[:, None] & (bidx == b)[None, :]
            first = torch.argmax(bp.to(torch.uint8), dim=0)
            lab = torch.where(bp.any(dim=0), cls[first], torch.zeros_like(first))
            labels = torch.where(bidx == b, lab, labels)
        onehot = nn.functional.one_hot(torch.clamp(labels, min=0), nc + 1)[:, 1:]
        num_pos = torch.clamp(((labels > 0) & valid).sum(), min=1)
        w = valid.to(logits.dtype) / num_pos
        return sigmoid_focal_cls_loss(logits, onehot.to(logits.dtype), w).sum()
