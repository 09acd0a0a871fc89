"""Dense heads (counterpart of pcseqlearning_tpu.models.dense_heads):
``AnchorHeadSingle`` (SECOND, SECOND-IoU, PointPillar) with its anchors and
target assignment, and ``CenterHead``.

Maps are NCHW; targets, losses and the decodes index the JAX modules' NHWC
flattening (cell-major: y, then x, then anchor or class) so that every
table compares row for row. The anchor head's predictions are kept in
JAX's [B, H, W, M, C] layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment_ops
from ..utils import loss_utils
from ..utils.box_coder_utils import ResidualCoder
from .backbones_2d import conv2d
from .layers import BatchNorm2d


# ---------------------------------------------------------------------------
# anchors and their targets
# ---------------------------------------------------------------------------


def generate_anchors(grid_size_xy, point_cloud_range, anchor_sizes, anchor_rotations,
                     anchor_heights):
    """[ny, nx, S, R, 7] anchors (NumPy float32) at the centres of the
    feature grid's cells, for S sizes (each with its bottom height) and R
    rotations; grid_size_xy = (nx, ny) of the feature map."""
    nx, ny = grid_size_xy
    pcr = np.asarray(point_cloud_range, np.float32)
    stride_x = (pcr[3] - pcr[0]) / nx
    stride_y = (pcr[4] - pcr[1]) / ny
    xs = pcr[0] + (np.arange(nx, dtype=np.float32) + 0.5) * stride_x
    ys = pcr[1] + (np.arange(ny, dtype=np.float32) + 0.5) * stride_y
    sizes = np.asarray(anchor_sizes, np.float32)
    rots = np.asarray(anchor_rotations, np.float32)
    hts = np.asarray(anchor_heights, np.float32)
    anchors = np.zeros((ny, nx, len(sizes), len(rots), 7), np.float32)
    anchors[..., 0] = xs[None, :, None, None]
    anchors[..., 1] = ys[:, None, None, None]
    anchors[..., 2] = (hts + sizes[:, 2] / 2.0)[None, None, :, None]  # bottom + dz / 2
    anchors[..., 3:6] = sizes[None, None, :, None, :]
    anchors[..., 6] = rots[None, None, None, :]
    return anchors


def _nearest_bev_boxes(boxes):
    """Axis-aligned BEV extents (x1, y1, x2, y2), the heading rounded to the
    nearest multiple of pi / 2."""
    rot = torch.abs(torch.remainder(boxes[..., 6], math.pi))
    swap = (rot > math.pi / 4) & (rot < 3 * math.pi / 4)
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    return (boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2, boxes[..., 0] + dx / 2,
            boxes[..., 1] + dy / 2)


def nearest_bev_iou(boxes_a, boxes_b):
    """[A, B] IoU of the nearest axis-aligned BEV boxes (the anchor
    matcher's)."""
    ax1, ay1, ax2, ay2 = _nearest_bev_boxes(boxes_a)
    bx1, by1, bx2, by2 = _nearest_bev_boxes(boxes_b)
    iw = loss_utils.relu_split(torch.minimum(ax2[:, None], bx2[None, :])
                               - torch.maximum(ax1[:, None], bx1[None, :]))
    ih = loss_utils.relu_split(torch.minimum(ay2[:, None], by2[None, :])
                               - torch.maximum(ay1[:, None], by1[None, :]))
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1))[:, None] + ((bx2 - bx1) * (by2 - by1))[None, :] - inter
    return inter / torch.maximum(union, union.new_tensor(1e-6))


def assign_anchor_targets(anchors_flat, gt_boxes, gt_classes, gt_valid, class_id, matched_thr,
                          unmatched_thr, coder, anchor_mask=None):
    """One class's anchor assignment for one sample: anchors_flat [A, 7],
    gt_boxes [G, 7], gt_classes / gt_valid [G], class_id from 1;
    ``anchor_mask`` [A] limits matching and force-matching to the class's
    own anchor rows. Returns labels [A] (-1 ignore, 0 background, class_id
    foreground), regression targets [A, code_size] and the foreground mask.

    Each GT force-matches its best anchor. Where several GTs pick one anchor
    (a padded GT's IoU column is all -1, so it picks anchor 0), that anchor
    takes the value of the last of them in table order: what XLA's scatter
    gives on the CPU (``zeros.at[best].set(g_mask)``), computed here as
    ``g_mask`` at each anchor's largest GT index, which is deterministic on
    the card."""
    a = anchors_flat.shape[0]
    dev = anchors_flat.device
    g_mask = gt_valid & (gt_classes == class_id)
    if anchor_mask is None:
        anchor_mask = torch.ones(a, dtype=torch.bool, device=dev)
    iou = nearest_bev_iou(anchors_flat, gt_boxes)
    iou = torch.where(g_mask[None, :] & anchor_mask[:, None], iou, iou.new_tensor(-1.0))
    max_iou = iou.amax(dim=1)
    argmax_gt = torch.argmax(iou, dim=1)
    labels = torch.full((a,), -1, dtype=torch.int64, device=dev)
    labels = torch.where(max_iou >= matched_thr, class_id, labels)
    labels = torch.where(max_iou < unmatched_thr, 0, labels)
    best_anchor = torch.argmax(iou, dim=0)  # [G]
    last = torch.full((a,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, best_anchor, torch.arange(best_anchor.shape[0], device=dev), "amax")
    force = (last >= 0) & g_mask[last.clamp(min=0)] & anchor_mask
    labels = torch.where(force, class_id, labels)
    forced_gt = torch.argmax(torch.where(force[:, None], iou, iou.new_tensor(-1.0)), dim=1)
    argmax_gt = torch.where(force, forced_gt, argmax_gt)
    reg = coder.encode(gt_boxes[argmax_gt], anchors_flat)
    fg = (labels == class_id) & anchor_mask
    labels = torch.where(anchor_mask, labels, -1)
    return labels, torch.where(fg[:, None], reg, reg.new_zeros(())), fg


class AnchorHeadSingle(nn.Module):
    """Single-scale anchor head: 1x1 convs for the class scores, the box
    residuals, the direction bins and, with ``predict_iou`` (SECONDNetIoU),
    the IoU rectification. ``anchor_cfgs``: per class in order, a dict of
    sizes, rotations, heights, matched_threshold and unmatched_threshold;
    class ci owns its rows of each location's anchors."""

    # the JAX module's defaults, which no config changes
    dir_offset, num_dir_bins, code_weights = 0.78539, 2, (1.0,) * 7

    def __init__(self, input_channels, num_classes, grid_size_xy, point_cloud_range, anchor_cfgs,
                 predict_iou=False, generator=None):
        super().__init__()
        self.num_classes, self.predict_iou = num_classes, predict_iou
        self.anchor_cfgs = [dict(c) for c in anchor_cfgs]
        anchors, slices, off = [], [], 0
        for cfg in self.anchor_cfgs:
            a = generate_anchors(grid_size_xy, point_cloud_range, cfg["sizes"], cfg["rotations"],
                                 cfg["heights"])
            a = a.reshape(a.shape[0], a.shape[1], -1, 7)
            anchors.append(a)
            slices.append((off, a.shape[2]))
            off += a.shape[2]
        self.anchor_class_slices = tuple(slices)
        # [ny, nx, M, 7], a constant of the geometry (not in the state_dict)
        self.register_buffer("anchors", torch.from_numpy(np.concatenate(anchors, axis=2)),
                             persistent=False)
        m = self.num_anchors_per_loc = self.anchors.shape[2]
        self.coder = ResidualCoder()
        c = input_channels
        self.conv_cls = conv2d(c, m * num_classes, 1, bias=True, generator=generator)
        self.conv_box = conv2d(c, m * self.coder.code_size, 1, bias=True, generator=generator)
        self.conv_dir = conv2d(c, m * self.num_dir_bins, 1, bias=True, generator=generator)
        if predict_iou:
            self.conv_iou = conv2d(c, m, 1, bias=True, generator=generator)

    def _nhwmc(self, conv, x, c):
        """A 1x1 conv's NCHW output as [B, H, W, M, c] (JAX's channel order
        m * c + k)."""
        y = conv(x).permute(0, 2, 3, 1)
        return y.reshape(y.shape[0], y.shape[1], y.shape[2], self.num_anchors_per_loc, c)

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]
        batch_dict["cls_preds"] = self._nhwmc(self.conv_cls, x, self.num_classes)
        batch_dict["box_preds"] = self._nhwmc(self.conv_box, x, self.coder.code_size)
        batch_dict["dir_preds"] = self._nhwmc(self.conv_dir, x, self.num_dir_bins)
        batch_dict["anchors"] = self.anchors
        if self.predict_iou:
            batch_dict["iou_preds"] = self._nhwmc(self.conv_iou, x, 1)[..., 0]
        return batch_dict

    def assign_targets(self, gt_b):
        """One sample's targets over every class: gt_b [G, 8] (box, class;
        class 0 pads) -> labels [A], regression targets [A, 7]. They are
        assigned in float32, whatever the module's dtype: the matching is
        discrete (thresholds, argmax ties among equal IoUs), and float32 is
        the JAX package's arithmetic."""
        anchors_flat = self.anchors.reshape(-1, 7).float()
        gt_b = gt_b.float()
        a = anchors_flat.shape[0]
        gt_boxes, gt_cls = gt_b[:, :7], gt_b[:, 7].to(torch.int64)
        labels = torch.full((a,), -1, dtype=torch.int64, device=gt_b.device)
        regs = gt_b.new_zeros((a, self.coder.code_size))
        m_ids = torch.arange(a, device=gt_b.device) % self.num_anchors_per_loc
        for ci, cfg in enumerate(self.anchor_cfgs):
            off, cnt = self.anchor_class_slices[ci]
            amask = (m_ids >= off) & (m_ids < off + cnt)
            lab, reg, fg = assign_anchor_targets(
                anchors_flat, gt_boxes, gt_cls, gt_cls > 0, ci + 1, cfg["matched_threshold"],
                cfg["unmatched_threshold"], self.coder, anchor_mask=amask)
            labels = torch.where(amask, lab, labels)
            regs = torch.where((amask & fg)[:, None], reg, regs)
        return labels, regs

    def loss(self, batch_dict):
        """rpn_loss_cls (focal), rpn_loss_loc (smooth-L1 with the sin
        difference of the heading, times 2), rpn_loss_dir (cross-entropy of
        the direction bins, times 0.2), each the mean over samples, their
        sum rpn_loss, plus rpn_loss_iou for SECONDNetIoU."""
        anchors_flat = self.anchors.reshape(-1, 7).float()
        period = 2 * math.pi / self.num_dir_bins
        cls_l, loc_l, dir_l = [], [], []
        for b in range(batch_dict["gt_boxes"].shape[0]):
            labels, regs32 = self.assign_targets(batch_dict["gt_boxes"][b])
            cls_p = batch_dict["cls_preds"][b].reshape(-1, self.num_classes)
            regs = regs32.to(cls_p.dtype)
            box_p = batch_dict["box_preds"][b].reshape(-1, self.coder.code_size)
            dir_p = batch_dict["dir_preds"][b].reshape(-1, self.num_dir_bins)
            pos, neg = labels > 0, labels == 0
            num_pos = torch.clamp(pos.to(cls_p.dtype).sum(), min=1.0)
            cls_w = (pos | neg).to(cls_p.dtype) / num_pos
            one_hot = F.one_hot(torch.clamp(labels, min=0), self.num_classes + 1)[:, 1:]
            cls_l.append(loss_utils.sigmoid_focal_cls_loss(cls_p, one_hot.to(cls_p.dtype),
                                                           cls_w).sum())
            reg_w = pos.to(cls_p.dtype) / num_pos
            # the heading as sin(a - b) = sin a cos b - cos a sin b
            bp_sin = torch.cat([box_p[:, :6], (torch.sin(box_p[:, 6]) * torch.cos(regs[:, 6]))[:, None],
                                box_p[:, 7:]], dim=1)
            rg_sin = torch.cat([regs[:, :6], (torch.cos(box_p[:, 6]) * torch.sin(regs[:, 6]))[:, None],
                                regs[:, 7:]], dim=1)
            loc_l.append(loss_utils.weighted_smooth_l1_loss(
                bp_sin, rg_sin, reg_w, code_weights=self.code_weights).sum())
            gt_rot = anchors_flat[:, 6] + regs32[:, 6]
            dir_t = torch.floor((gt_rot - self.dir_offset) / period).to(torch.int64)
            dir_t = torch.clamp(dir_t % self.num_dir_bins, 0, self.num_dir_bins - 1)
            dir_l.append(loss_utils.weighted_cross_entropy_loss(
                dir_p, F.one_hot(dir_t, self.num_dir_bins).to(dir_p.dtype), reg_w).sum())
        losses = {"rpn_loss_cls": torch.stack(cls_l).mean(),
                  "rpn_loss_loc": torch.stack(loc_l).mean() * 2.0,
                  "rpn_loss_dir": torch.stack(dir_l).mean() * 0.2}
        losses["rpn_loss"] = losses["rpn_loss_cls"] + losses["rpn_loss_loc"] + losses["rpn_loss_dir"]
        if self.predict_iou:
            losses["rpn_loss_iou"] = self.iou_loss(batch_dict)
            losses["rpn_loss"] = losses["rpn_loss"] + losses["rpn_loss_iou"]
        return losses

    def iou_loss(self, batch_dict):
        """SECONDNetIoU's rectification loss: smooth-L1 between
        sigmoid(iou_preds) and clip(2 * iou - 0.5, 0, 1), where iou is each
        decoded box's best nearest-BEV IoU with a GT, over the boxes whose
        iou exceeds 0.3. No gradient is stopped: the targets carry the box
        residuals' gradient, as in JAX."""
        anchors_flat = self.anchors.reshape(-1, 7)
        iou_preds = batch_dict["iou_preds"]
        b = iou_preds.shape[0]
        box_preds = batch_dict["box_preds"].reshape(b, -1, self.coder.code_size)
        out = []
        for i in range(b):
            gt_b = batch_dict["gt_boxes"][i]
            iou = nearest_bev_iou(self.coder.decode(box_preds[i], anchors_flat), gt_b[:, :7])
            best = torch.where((gt_b[:, 7] > 0)[None, :], iou, iou.new_zeros(())).amax(dim=1)
            fg = best > 0.3
            tgt = loss_utils.clip_split(2.0 * best - 0.5, 0.0, 1.0)
            w = fg.to(best.dtype) / torch.clamp(fg.sum(), min=1).to(best.dtype)
            diff = torch.sigmoid(iou_preds[i].reshape(-1)) - tgt
            out.append((loss_utils.smooth_l1(diff) * w).sum())
        return torch.stack(out).mean()

    def generate_predicted_boxes(self, batch_dict):
        """(boxes [B, A, 7] decoded from the anchors, the heading put in the
        predicted direction bin; class scores [B, A, num_classes])."""
        b = batch_dict["cls_preds"].shape[0]
        anchors_flat = self.anchors.reshape(-1, 7)
        cls = torch.sigmoid(batch_dict["cls_preds"].reshape(b, -1, self.num_classes))
        boxes = self.coder.decode(batch_dict["box_preds"].reshape(b, -1, self.coder.code_size),
                                  anchors_flat[None])
        dir_labels = torch.argmax(batch_dict["dir_preds"].reshape(b, -1, self.num_dir_bins), dim=-1)
        period = 2 * math.pi / self.num_dir_bins
        rot = boxes[..., 6] - self.dir_offset
        rot = rot - torch.floor(rot / period) * period
        rot = rot + self.dir_offset + period * dir_labels.to(rot.dtype)
        return torch.cat([boxes[..., :6], rot[..., None]], dim=-1), cls


# ---------------------------------------------------------------------------
# CenterHead
# ---------------------------------------------------------------------------


def gaussian_radius(dx, dy, min_overlap=0.1):
    """CenterNet's gaussian radius (the reference's
    centernet_utils.gaussian_radius)."""
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    b1 = dx + dy
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.maximum(b1 ** 2 - 4 * c1, zero))) / 2
    b2 = 2 * (dx + dy)
    c2 = (1 - min_overlap) * dx * dy
    r2 = (b2 + torch.sqrt(torch.maximum(b2 ** 2 - 4 * 4 * c2, zero))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dx + dy)
    c3 = (min_overlap - 1) * dx * dy
    r3 = (b3 + torch.sqrt(torch.maximum(b3 ** 2 - 4 * a3 * c3, zero))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def _gather_rows(x, idx):
    """x[b, idx[b, k]] for x [B, N, C], idx [B, K], through
    ``segment_ops.take_rows`` on the [B * N, C] view (a backward that is
    reproducible on the card)."""
    b, n, c = x.shape
    flat = idx + torch.arange(b, device=idx.device)[:, None] * n
    return segment_ops.take_rows(x.reshape(b * n, c), flat.reshape(-1)).reshape(b, -1, c)


def _nhwc_rows(maps):
    """Concatenate NCHW maps on channels and flatten to [B, H * W, C]."""
    x = torch.cat(maps, dim=1)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


class CenterHead(nn.Module):
    """Centre-based head, one head group over all classes: a shared conv,
    then heatmap, centre offset, centre z, log dims and (cos, sin) maps."""

    def __init__(self, input_channels, num_classes, grid_size_xy, point_cloud_range,
                 feature_stride=8, shared_channels=64, max_objs=500, gaussian_overlap=0.1,
                 min_radius=2, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.grid_size_xy = tuple(grid_size_xy)
        self.point_cloud_range = tuple(point_cloud_range)
        self.feature_stride = feature_stride
        self.max_objs, self.gaussian_overlap, self.min_radius = max_objs, gaussian_overlap, min_radius
        self.shared_conv = conv2d(input_channels, shared_channels, 3, padding=1,
                                  generator=generator)
        self.shared_bn = BatchNorm2d(shared_channels)
        outs = dict(hm=num_classes, center=2, center_z=1, dim=3, rot=2)
        for name, c in outs.items():
            setattr(self, name, conv2d(shared_channels, c, 3, padding=1, bias=True,
                                       generator=generator))
        nn.init.constant_(self.hm.bias, -2.19)
        self.out_names = tuple(outs)

    def forward(self, batch_dict):
        x = torch.relu(self.shared_bn(self.shared_conv(batch_dict["spatial_features_2d"])))
        batch_dict["center_preds"] = {name: getattr(self, name)(x) for name in self.out_names}
        return batch_dict

    def _geometry(self, device):
        """(range, cell sizes vx, vy, feature map width, height), float32
        as in JAX. The cell sizes are divided on the host: on the card a
        tensor divided by a Python number is multiplied by its reciprocal,
        which can round the last bit otherwise."""
        pcr = torch.tensor(self.point_cloud_range, dtype=torch.float32)
        nx, ny = self.grid_size_xy
        fx = -(-nx // self.feature_stride)
        fy = -(-ny // self.feature_stride)
        return (pcr.to(device), ((pcr[3] - pcr[0]) / nx).to(device),
                ((pcr[4] - pcr[1]) / ny).to(device), fx, fy)

    def build_targets(self, gt_boxes):
        """gt_boxes [B, G, 8] (box, class; class 0 pads). Returns heatmap
        [B, fy, fx, ncls], reg targets [B, K, 8], inds [B, K], mask [B, K]
        with K = max_objs, in the boxes' dtype (float32 as in JAX, or float64
        for a network run in float64, whose targets then carry no float32
        rounding)."""
        pcr, vx, vy, fx, fy = self._geometry(gt_boxes.device)
        s, dt = self.feature_stride, gt_boxes.dtype
        boxes, cls = gt_boxes[..., :7], gt_boxes[..., 7].to(torch.int32)
        cx = (boxes[..., 0] - pcr[0]) / vx / s
        cy = (boxes[..., 1] - pcr[1]) / vy / s
        dx = boxes[..., 3] / vx / s
        dy = boxes[..., 4] / vy / s
        radius = gaussian_radius(dy, dx, self.gaussian_overlap)
        radius = torch.clamp(radius.to(torch.int32), min=self.min_radius).to(dt)
        ix = torch.clamp(cx.to(torch.int32), 0, fx - 1)
        iy = torch.clamp(cy.to(torch.int32), 0, fy - 1)
        ok = (cls > 0) & (cx >= 0) & (cx < fx) & (cy >= 0) & (cy < fy) & (dx > 0) & (dy > 0)

        # the heatmap: per class, the max over its boxes of their gaussians
        dev = gt_boxes.device
        xg = torch.arange(fx, dtype=dt, device=dev)
        yg = torch.arange(fy, dtype=dt, device=dev)
        sigma = radius / 3.0
        d2 = ((xg[None, None, None, :] - ix.to(dt)[..., None, None]) ** 2
              + (yg[None, None, :, None] - iy.to(dt)[..., None, None]) ** 2)
        g = torch.exp(-d2 / torch.clamp(2 * sigma * sigma, min=1e-6)[..., None, None])
        g = torch.where(ok[..., None, None], g, torch.zeros((), device=dev))  # [B, G, fy, fx]
        c = torch.clamp(cls - 1, 0, self.num_classes - 1)
        onehot = F.one_hot(c.long(), self.num_classes).to(g.dtype)  # [B, G, ncls]
        hm = (g[..., None] * onehot[:, :, None, None, :]).amax(dim=1)

        K, G = self.max_objs, gt_boxes.shape[1]
        src = torch.stack([cx - ix.to(dt), cy - iy.to(dt), boxes[..., 2],
                           torch.log(torch.clamp(boxes[..., 3], min=1e-5)),
                           torch.log(torch.clamp(boxes[..., 4], min=1e-5)),
                           torch.log(torch.clamp(boxes[..., 5], min=1e-5)),
                           torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])], dim=-1)
        inds = (iy * fx + ix).long()
        pad = max(K - G, 0)
        inds = F.pad(inds[:, :K], (0, pad))
        mask = F.pad(ok[:, :K], (0, pad))
        tgt = F.pad(src[:, :K], (0, 0, 0, pad))
        return hm, tgt, inds, mask

    def _reg_rows(self, preds):
        return _nhwc_rows([preds["center"], preds["center_z"], preds["dim"], preds["rot"]])

    def loss(self, batch_dict):
        preds = batch_dict["center_preds"]
        hm_t, reg_t, inds, mask = self.build_targets(batch_dict["gt_boxes"])
        hm_p = torch.sigmoid(preds["hm"]).permute(0, 2, 3, 1)
        hm_loss = loss_utils.focal_loss_centernet(hm_p, hm_t)
        gathered = _gather_rows(self._reg_rows(preds), inds)
        loc_loss = loss_utils.reg_loss_centernet(gathered, reg_t, mask).sum()
        return {"hm_loss": hm_loss, "loc_loss": loc_loss * 2.0,
                "center_loss": hm_loss + loc_loss * 2.0}

    def generate_predicted_boxes(self, batch_dict, k=500, score_thresh=0.1):
        """Top-K peak decode (the reference's decode_bbox_from_heatmap):
        (boxes [B, K, 7], scores [B, K], labels [B, K] from 1, valid [B, K]).
        Ties keep the lower flat index first, as ``lax.top_k`` does."""
        preds = batch_dict["center_preds"]
        hm = torch.sigmoid(preds["hm"])
        b, ncls, fy, fx = hm.shape
        pcr, vx, vy, _, _ = self._geometry(hm.device)
        pooled = F.max_pool2d(hm, 3, stride=1, padding=1)
        hm = torch.where(torch.abs(hm - pooled) < 1e-6, hm, torch.zeros((), device=hm.device))
        flat = hm.permute(0, 2, 3, 1).reshape(b, fy * fx * ncls)
        k = min(k, flat.shape[1])
        scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, idx = scores[:, :k], idx[:, :k]
        cls_id = idx % ncls
        spatial = idx // ncls
        iy, ix = spatial // fx, spatial % fx
        g = _gather_rows(self._reg_rows(preds), spatial)
        s = self.feature_stride
        cx = (ix.to(torch.float32) + g[..., 0]) * vx * s + pcr[0]
        cy = (iy.to(torch.float32) + g[..., 1]) * vy * s + pcr[1]
        dims = torch.exp(g[..., 3:6])
        rot = torch.atan2(g[..., 7], g[..., 6])
        boxes = torch.stack([cx, cy, g[..., 2], dims[..., 0], dims[..., 1], dims[..., 2], rot],
                            dim=-1)
        return boxes, scores, cls_id + 1, scores > score_thresh
