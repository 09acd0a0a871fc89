"""Point-based backbones and heads (counterpart of
pcseqlearning_tpu.models.backbones_point): PointRCNN's ``PointNet2MSG``
(set abstraction ``SALayer``, feature propagation ``FPLayer``) and its
first stage ``PointHeadBox``, and ``PointHeadSimple``, the PV-RCNN++
co-train's segmentation head over the keypoints.

Gathers that carry a gradient go through ``segment_ops.take_rows`` (a
reproducible backward on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import sampling, segment_ops
from ..ops.boxes import points_in_boxes
from ..utils.box_coder_utils import PointResidualCoder
from ..utils.loss_utils import sigmoid_focal_cls_loss, weighted_smooth_l1_loss
from .layers import MaskedBatchNorm
from .pfe import SAGroup
from .vfe import linear


class SALayer(nn.Module):
    """Set abstraction: ``npoint`` centres by one farthest point sampling
    over the whole table, each sample's points shifted by 1e4 times its
    batch index (so a sample's share of the centres follows its extent, as
    in JAX), then ``SAGroup`` (ball query, shared MLP, max) around them.
    ``cin`` is the input features' width."""

    def __init__(self, cin, npoint, radius, nsample, mlp, generator=None):
        super().__init__()
        self.npoint = npoint
        self.group = SAGroup(cin, radius, nsample, mlp, generator=generator)

    def forward(self, xyz, batch_idx, feats, valid):
        sep = batch_idx.to(xyz.dtype)[:, None] * 1e4
        idx = sampling.farthest_point_sample(xyz + sep, self.npoint, valid=valid)
        new_xyz, new_batch, new_valid = xyz[idx], batch_idx[idx], valid[idx]
        out = self.group(new_xyz, new_batch, xyz, batch_idx, feats, valid)
        return new_xyz, new_batch, out, new_valid, idx


class FPLayer(nn.Module):
    """Feature propagation: each fine point takes the inverse-distance
    weighted mean of its 3 nearest coarse points of its own sample
    (``knn_bruteforce``; weights 1 / max(d^2, 1e-8), normalised), joined
    after its own features, then a unit MLP (linear without bias,
    ``MaskedBatchNorm``, ReLU per layer); rows not valid come out zero."""

    def __init__(self, cin, mlp, generator=None):
        super().__init__()
        self.num_layers = len(mlp)
        for i, c in enumerate(mlp):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c

    def forward(self, fine_xyz, fine_batch, fine_feats, fine_valid, coarse_xyz, coarse_batch,
                coarse_feats, coarse_valid):
        idx, d2 = sampling.knn_bruteforce(coarse_xyz, fine_xyz, 3, ref_valid=coarse_valid,
                                          ref_batch=coarse_batch, query_batch=fine_batch)
        w = 1.0 / torch.clamp(d2, min=1e-8)
        w = w / w.sum(dim=1, keepdim=True)
        near = segment_ops.take_rows(coarse_feats, idx.reshape(-1)).reshape(idx.shape[0], 3, -1)
        x = (near * w[..., None].to(near.dtype)).sum(dim=1)
        if fine_feats is not None:
            x = torch.cat([fine_feats.to(x.dtype), x], dim=-1)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), fine_valid))
        return torch.where(fine_valid[:, None], x, x.new_zeros(()))


class PointNet2MSG(nn.Module):
    """PointNet++ encoder and decoder over the raw point table: four
    ``SALayer`` levels (the JAX module's defaults: 4,096, 1,024, 256 and 64
    centres, radii 0.4-3.2 m, 16 samples, widths 32-256, one scale per
    level), then four ``FPLayer`` back to the points. Writes
    ``point_features`` [N, channels[0]] and ``point_coords`` [N, 4] (batch
    index, xyz). ``cin`` is the width of ``point_feat``."""

    def __init__(self, cin=1, npoints=(4096, 1024, 256, 64), radii=(0.4, 0.8, 1.6, 3.2),
                 nsamples=(16, 16, 16, 16), channels=(32, 64, 128, 256), generator=None):
        super().__init__()
        self.num_levels = len(npoints)
        widths = [cin]
        for i in range(self.num_levels):
            setattr(self, f"sa{i}", SALayer(widths[-1], npoints[i], radii[i], nsamples[i],
                                            (channels[i], channels[i]), generator=generator))
            widths.append(channels[i])
        up = widths[-1]
        for i in range(self.num_levels - 1, -1, -1):
            c = channels[max(i - 1, 0)]
            setattr(self, f"fp{i}", FPLayer(widths[i] + up, (c, c), generator=generator))
            up = c
        self.out_channels = up

    def forward(self, batch_dict):
        pts = batch_dict["point_bxyz"]
        n = pts.shape[0]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=pts.device)
        feats = batch_dict.get("point_feat")
        if feats is None:
            feats = pts.new_zeros((n, 1))
        xyz, bidx = pts[:, 1:4], torch.round(pts[:, 0]).long()
        levels = [(xyz, bidx, feats, valid)]
        for i in range(self.num_levels):
            nx, nb, nf, nv, _ = getattr(self, f"sa{i}")(*levels[-1])
            levels.append((nx, nb, nf, nv))
        up = levels[-1][2]
        for i in range(self.num_levels - 1, -1, -1):
            fx, fb, ff, fv = levels[i]
            cx, cb, _, cv = levels[i + 1]
            up = getattr(self, f"fp{i}")(fx, fb, ff, fv, cx, cb, up, cv)
        batch_dict["point_features"] = up
        batch_dict["point_coords"] = torch.cat([bidx[:, None].to(xyz.dtype), xyz], dim=1)
        return batch_dict


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


class PointHeadBox(nn.Module):
    """PointRCNN's first stage: per point, a hidden MLP (linear without
    bias, ``MaskedBatchNorm``, ReLU per width) over ``point_features``, then
    class logits (``point_cls_preds``, linear ``cls``) and an 8-channel
    ``PointResidualCoder`` box (``point_box_preds``, linear ``box``)."""

    def __init__(self, cin, num_classes, hidden=(256, 256), generator=None):
        super().__init__()
        self.num_hidden = len(hidden)
        for i, c in enumerate(hidden):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c
        self.cls = linear(cin, num_classes, bias=True, generator=generator)
        self.box = linear(cin, PointResidualCoder().code_size, bias=True, generator=generator)

    def forward(self, batch_dict):
        h = batch_dict["point_features"]
        valid = _point_valid(batch_dict, h.shape[0], h.device)
        for i in range(self.num_hidden):
            h = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(h), valid))
        batch_dict["point_cls_preds"] = self.cls(h)
        batch_dict["point_box_preds"] = self.box(h)
        return batch_dict

    @staticmethod
    def assign_targets(coords, valid, gt_boxes):
        """Per point, (label [N]: the class of the first GT box of its sample
        (class > 0) that holds it, 0 for a point in none or not valid; box
        target [N, 8]: that box encoded against the point, zeros elsewhere).
        coords [N, 4] (batch index, xyz); gt_boxes [B, G, 8]."""
        coder = PointResidualCoder()
        n = coords.shape[0]
        bidx = torch.round(coords[:, 0]).long()
        labels = torch.zeros(n, dtype=torch.int64, device=coords.device)
        box_t = coords.new_zeros((n, coder.code_size))
        for b in range(gt_boxes.shape[0]):
            boxes, cls = gt_boxes[b, :, :7], gt_boxes[b, :, 7].long()
            bp = points_in_boxes(coords[:, 1:4], boxes) & (cls > 0)[:, None]
            sel = bidx == b
            in_any = bp.any(dim=0) & sel & valid
            gi = torch.argmax(bp.to(torch.uint8), dim=0)
            labels = torch.where(sel, torch.where(in_any, cls[gi], torch.zeros_like(gi)), labels)
            tgt = coder.encode(boxes[gi], coords[:, 1:4], cls[gi]).to(box_t.dtype)
            box_t = torch.where((sel & in_any)[:, None], tgt, box_t)
        return labels, box_t

    @staticmethod
    def loss(batch_dict, gt_boxes):
        """{point_loss_cls: sigmoid focal loss over the valid points,
        point_loss_box: smooth-L1 over the valid foreground points, both
        over the count of those (at least 1); point_loss: their sum}."""
        logits, box_p = batch_dict["point_cls_preds"], batch_dict["point_box_preds"]
        valid = _point_valid(batch_dict, logits.shape[0], logits.device)
        nc = logits.shape[-1]
        labels, box_t = PointHeadBox.assign_targets(batch_dict["point_coords"], valid, gt_boxes)
        onehot = nn.functional.one_hot(torch.clamp(labels, min=0), nc + 1)[:, 1:]
        fg = (labels > 0) & valid
        num_pos = torch.clamp(fg.sum(), min=1)
        cls_loss = sigmoid_focal_cls_loss(logits, onehot.to(logits.dtype),
                                          valid.to(logits.dtype) / num_pos).sum()
        reg_loss = weighted_smooth_l1_loss(box_p, box_t.to(box_p.dtype),
                                           fg.to(box_p.dtype) / num_pos).sum()
        return {"point_loss_cls": cls_loss, "point_loss_box": reg_loss,
                "point_loss": cls_loss + reg_loss}

    @staticmethod
    def generate_predicted_boxes(batch_dict):
        """Per point (boxes [N, 7] decoded at the point for its best class,
        scores [N]: the best class's sigmoid, 0 where not valid, classes
        [N] from 1)."""
        logits = batch_dict["point_cls_preds"]
        coords = batch_dict["point_coords"]
        valid = _point_valid(batch_dict, logits.shape[0], logits.device)
        probs = torch.sigmoid(logits)
        scores = torch.where(valid, probs.amax(dim=-1), probs.new_zeros(()))
        cls_pred = torch.argmax(probs, dim=-1) + 1
        boxes = PointResidualCoder().decode(batch_dict["point_box_preds"], coords[:, 1:4],
                                            cls_pred)
        return boxes, scores, cls_pred
