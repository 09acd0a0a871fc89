"""Box coders (counterpart of pcseqlearning_tpu.utils.box_coder_utils):
``ResidualCoder``, the SECOND / PointPillars coding of boxes as residuals
of anchors (log sizes, centre offsets over the anchor's BEV diagonal).
``PointResidualCoder`` is PointRCNN's and waits for it (ROADMAP.md, queue 1
item 4.3)."""

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
