"""CenterHead (counterpart of the CenterHead part of
pcseqlearning_tpu.models.dense_heads). ``AnchorHeadSingle`` waits for the
detectors that use it (ROADMAP.md, queue 1 item 4).

Maps are NCHW; targets, losses and the decode index the JAX module's NHWC
flattening (cell-major, class-minor) so that every table compares row for
row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import segment_ops
from ..utils import loss_utils
from .backbones_2d import conv2d
from .layers import BatchNorm2d


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


class _GatherRows(torch.autograd.Function):
    """x[b, idx[b, k]] for x [B, N, C], idx [B, K]; the backward sums dY
    into the rows by ``segment_ops.segment_sum`` (reproducible on the card,
    where autograd's index backward would add with atomics)."""

    @staticmethod
    def forward(ctx, x, idx):
        b, n, c = x.shape
        flat = (idx + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
        ctx.save_for_backward(flat)
        ctx.shape = x.shape
        return x.reshape(b * n, c)[flat].reshape(b, -1, c)

    @staticmethod
    def backward(ctx, dy):
        (flat,) = ctx.saved_tensors
        b, n, c = ctx.shape
        g = segment_ops.segment_sum(dy.reshape(-1, c), flat, b * n)
        return g.reshape(b, n, c), None


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
        pcr = torch.tensor(self.point_cloud_range, dtype=torch.float32, device=device)
        nx, ny = self.grid_size_xy
        fx = -(-nx // self.feature_stride)
        fy = -(-ny // self.feature_stride)
        return pcr, (pcr[3] - pcr[0]) / nx, (pcr[4] - pcr[1]) / ny, fx, fy

    def build_targets(self, gt_boxes):
        """gt_boxes [B, G, 8] (box, class; class 0 pads). Returns heatmap
        [B, fy, fx, ncls], reg targets [B, K, 8], inds [B, K], mask [B, K]
        with K = max_objs."""
        pcr, vx, vy, fx, fy = self._geometry(gt_boxes.device)
        s = self.feature_stride
        boxes, cls = gt_boxes[..., :7], gt_boxes[..., 7].to(torch.int32)
        cx = (boxes[..., 0] - pcr[0]) / vx / s
        cy = (boxes[..., 1] - pcr[1]) / vy / s
        dx = boxes[..., 3] / vx / s
        dy = boxes[..., 4] / vy / s
        radius = gaussian_radius(dy, dx, self.gaussian_overlap)
        radius = torch.clamp(radius.to(torch.int32), min=self.min_radius).to(torch.float32)
        ix = torch.clamp(cx.to(torch.int32), 0, fx - 1)
        iy = torch.clamp(cy.to(torch.int32), 0, fy - 1)
        ok = (cls > 0) & (cx >= 0) & (cx < fx) & (cy >= 0) & (cy < fy) & (dx > 0) & (dy > 0)

        # the heatmap: per class, the max over its boxes of their gaussians
        dev = gt_boxes.device
        xg = torch.arange(fx, dtype=torch.float32, device=dev)
        yg = torch.arange(fy, dtype=torch.float32, device=dev)
        sigma = radius / 3.0
        d2 = ((xg[None, None, None, :] - ix.to(torch.float32)[..., None, None]) ** 2
              + (yg[None, None, :, None] - iy.to(torch.float32)[..., None, None]) ** 2)
        g = torch.exp(-d2 / torch.clamp(2 * sigma * sigma, min=1e-6)[..., None, None])
        g = torch.where(ok[..., None, None], g, torch.zeros((), device=dev))  # [B, G, fy, fx]
        c = torch.clamp(cls - 1, 0, self.num_classes - 1)
        onehot = F.one_hot(c.long(), self.num_classes).to(g.dtype)  # [B, G, ncls]
        hm = (g[..., None] * onehot[:, :, None, None, :]).amax(dim=1)

        K, G = self.max_objs, gt_boxes.shape[1]
        src = torch.stack([cx - ix.to(torch.float32), cy - iy.to(torch.float32), boxes[..., 2],
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
        gathered = _GatherRows.apply(self._reg_rows(preds), inds)
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
        g = torch.gather(self._reg_rows(preds), 1, spatial[..., None].expand(-1, -1, 8))
        s = self.feature_stride
        cx = (ix.to(torch.float32) + g[..., 0]) * vx * s + pcr[0]
        cy = (iy.to(torch.float32) + g[..., 1]) * vy * s + pcr[1]
        dims = torch.exp(g[..., 3:6])
        rot = torch.atan2(g[..., 7], g[..., 6])
        boxes = torch.stack([cx, cy, g[..., 2], dims[..., 0], dims[..., 1], dims[..., 2], rot],
                            dim=-1)
        return boxes, scores, cls_id + 1, scores > score_thresh
