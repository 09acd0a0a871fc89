"""Box coders (counterpart of pcseqlearning_tpu.utils.box_coder_utils):
``ResidualCoder``, the SECOND / PointPillars coding of boxes as residuals
of anchors (log sizes, centre offsets over the anchor's BEV diagonal), and
``PointResidualCoder``, PointRCNN's coding of boxes relative to points."""

from __future__ import annotations

import torch


class ResidualCoder:
    def __init__(self, code_size=7, encode_angle_by_sincos=False):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """boxes, anchors [..., 7+] -> residuals [..., code_size] (a box's
        channels past the seventh are appended as they are)."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(boxes[..., :7], 1, dim=-1)
        dxa, dya, dza = (torch.clamp(d, min=1e-5) for d in (dxa, dya, dza))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        parts = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                 torch.log(torch.clamp(dxg, min=1e-5) / dxa),
                 torch.log(torch.clamp(dyg, min=1e-5) / dya),
                 torch.log(torch.clamp(dzg, min=1e-5) / dza)]
        if self.encode_angle_by_sincos:
            parts += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            parts.append(rg - ra)
        return torch.cat(parts + [boxes[..., 7:]], dim=-1)

    def decode(self, residuals, anchors):
        """residuals [..., code_size], anchors [..., 7+] -> boxes [..., 7]."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.split(residuals[..., :8], 1, dim=-1)
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = torch.split(residuals[..., :7], 1, dim=-1)
            rg = rt + ra
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.cat([xt * diag + xa, yt * diag + ya, zt * dza + za, torch.exp(dxt) * dxa,
                          torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg], dim=-1)


class PointResidualCoder:
    """Boxes relative to points (PointRCNN): the centre's offset from the
    point over the class's mean-size BEV diagonal (z over its height), the
    log of each size over the class's mean size, and the heading as (cos,
    sin): 8 channels. ``mean_sizes`` [num_classes, 3] (dx, dy, dz) by class
    id from 1 (ids are clipped into the table), held in float32 as the JAX
    coder holds them and promoted to the boxes' dtype."""

    def __init__(self, mean_sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))):
        self.mean_sizes = torch.tensor(mean_sizes, dtype=torch.float32)
        self.code_size = 8

    def _means(self, classes, like):
        table = self.mean_sizes.to(device=like.device)
        m = table[torch.clamp(classes.long() - 1, 0, table.shape[0] - 1)].to(like.dtype)
        return m[..., 0], m[..., 1], m[..., 2]

    def encode(self, gt_boxes, points, gt_classes):
        """gt_boxes [..., 7], points [..., 3], gt_classes [...] -> [..., 8]."""
        dxa, dya, dza = self._means(gt_classes, gt_boxes)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (gt_boxes[..., 0] - points[..., 0]) / diag, (gt_boxes[..., 1] - points[..., 1]) / diag,
            (gt_boxes[..., 2] - points[..., 2]) / dza,
            torch.log(torch.clamp(gt_boxes[..., 3], min=1e-5) / dxa),
            torch.log(torch.clamp(gt_boxes[..., 4], min=1e-5) / dya),
            torch.log(torch.clamp(gt_boxes[..., 5], min=1e-5) / dza),
            torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], dim=-1)

    def decode(self, residuals, points, pred_classes):
        """residuals [..., 8], points [..., 3], pred_classes [...] -> boxes
        [..., 7], the heading atan2(sin, cos)."""
        dxa, dya, dza = self._means(pred_classes, residuals)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            residuals[..., 0] * diag + points[..., 0], residuals[..., 1] * diag + points[..., 1],
            residuals[..., 2] * dza + points[..., 2], torch.exp(residuals[..., 3]) * dxa,
            torch.exp(residuals[..., 4]) * dya, torch.exp(residuals[..., 5]) * dza,
            torch.atan2(residuals[..., 7], residuals[..., 6])], dim=-1)
