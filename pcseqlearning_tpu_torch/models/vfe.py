"""Voxel feature encoders (counterpart of pcseqlearning_tpu.models.vfe):
``DynamicMeanVFE`` (CenterPoint, SECOND, Voxel R-CNN) and ``DynPillarVFE``
(PointPillar). The other encoders wait for the detectors that use them
(ROADMAP.md, queue 1 item 4)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import grid_utils, segment_ops
from .layers import MaskedBatchNorm, init_fan_in


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


def linear(cin, cout, bias=False, generator=None):
    """nn.Linear initialised as flax's nn.Dense (lecun_normal, zero bias)."""
    lin = nn.Linear(cin, cout, bias=bias)
    init_fan_in(lin.weight, cin, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class DynPillarVFE(nn.Module):
    """Dynamic pillar encoder: each point's (x, y, z), features, offset from
    its pillar's point mean and offset from its pillar's centre go through
    the PFN (linear, ``MaskedBatchNorm``, ReLU per filter), then a max over
    the pillar's points. Pillars are the distinct (b, x cell, y cell) of the
    valid points inside the range, in lexicographic order, at most
    ``pillar_cap``; their coords are (b, 0, y, x). The max splits a tie's
    gradient evenly among the tied points, as JAX's ``segment_max``
    does."""

    def __init__(self, voxel_size, point_cloud_range, pillar_cap, num_filters=(64,),
                 num_point_features=4, generator=None):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = self.pillar_cap = int(pillar_cap)
        cin = num_point_features + 3 + 2  # x, y, z, features, cluster and pillar offsets
        for i, nf in enumerate(num_filters):
            setattr(self, f"linear{i}", linear(cin, nf, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(nf))
            cin = nf
        self.num_layers, self.out_channels = len(num_filters), cin

    def forward(self, batch_dict):
        points, feats = batch_dict["point_bxyz"], batch_dict["point_feat"]
        dev, n = points.device, points.shape[0]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        pcr = torch.tensor(self.point_cloud_range, dtype=points.dtype, device=dev)
        vs = torch.tensor(self.voxel_size, dtype=points.dtype, device=dev)
        xyz = points[:, 1:4]
        valid = valid & ((xyz >= pcr[:3]) & (xyz < pcr[3:])).all(dim=-1)
        b = torch.round(points[:, 0]).to(torch.int32)
        cxy = torch.floor((points[:, 1:3] - pcr[:2]) / vs[:2]).to(torch.int32)
        coords = torch.where(valid[:, None], torch.cat([b[:, None], cxy], 1),
                             torch.full((n, 3), 2 ** 24, dtype=torch.int32, device=dev))
        inverse, _, _ = grid_utils.unique_rows(coords)
        cap = self.pillar_cap
        inv_safe = torch.where(valid, inverse, torch.full_like(inverse, cap))

        mean_xyz = segment_ops.segment_mean(xyz, inv_safe, cap + 1)[:cap]
        f_cluster = xyz - mean_xyz[torch.clamp(inverse, 0, cap - 1)]
        f_center = points[:, 1:3] - ((cxy.to(points.dtype) + 0.5) * vs[:2] + pcr[:2])
        # the cells in the points' dtype, the PFN in the module's
        x = torch.cat([xyz, feats, f_cluster, f_center], dim=-1).to(self.linear0.weight.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid)
            x = torch.relu(x)
        x = torch.where(valid[:, None], x, torch.full_like(x, float("-inf")))
        pooled = segment_ops.segment_max_or(x, inv_safe, cap + 1, 0.0)[:cap]
        pvalid = segment_ops.segment_count(inv_safe, cap + 1)[:cap] > 0.5
        pc = segment_ops.segment_min_or(coords, inv_safe, cap + 1, 0)[:cap]
        vc = torch.stack([pc[:, 0], torch.zeros_like(pc[:, 0]), pc[:, 2], pc[:, 1]], dim=1)
        batch_dict["pillar_features"] = torch.where(pvalid[:, None], pooled,
                                                    torch.zeros_like(pooled))
        batch_dict["voxel_features"] = batch_dict["pillar_features"]
        batch_dict["voxel_coords"] = torch.where(pvalid[:, None], vc, torch.full_like(vc, -1))
        batch_dict["voxel_valid"] = pvalid
        return batch_dict
