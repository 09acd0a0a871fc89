"""Voxel feature encoders (counterpart of pcseqlearning_tpu.models.vfe):
``DynamicMeanVFE``, the one CenterPoint runs. The other encoders wait for
the detectors that use them (ROADMAP.md, queue 1 item 4)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import grid_utils


class DynamicMeanVFE(nn.Module):
    """Mean of (x, y, z, point features) per voxel over the points inside
    the range, with no cap on the points per voxel. Points outside the
    range or not valid are moved to 1e8 (their own voxel, last in order),
    as in the JAX module."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = int(voxel_cap)

    def forward(self, batch_dict):
        points = batch_dict["point_bxyz"]
        feats = batch_dict["point_feat"]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
        pcr = torch.tensor(self.point_cloud_range, dtype=points.dtype, device=points.device)
        inside = ((points[:, 1:4] >= pcr[:3]) & (points[:, 1:4] < pcr[3:])).all(dim=-1)
        valid = valid & inside
        pts = torch.where(valid[:, None], points, torch.full_like(points, 1e8))
        full = torch.cat([points[:, 1:4], feats], dim=-1)
        coords, vfeat, vvalid, inverse = grid_utils.dynamic_voxelize(
            pts, full, self.voxel_size, pcr[:3], self.voxel_cap)
        batch_dict["voxel_features"] = torch.where(vvalid[:, None], vfeat,
                                                   torch.zeros_like(vfeat))
        batch_dict["voxel_coords"] = torch.where(vvalid[:, None], coords,
                                                 torch.full_like(coords, -1))
        batch_dict["voxel_valid"] = vvalid
        batch_dict["point_voxel_inverse"] = inverse
        return batch_dict
