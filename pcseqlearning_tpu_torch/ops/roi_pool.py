"""RoI pooling geometry (counterpart of pcseqlearning_tpu.ops.roi_pool):
``roi_grid_points`` only, the grid Voxel R-CNN's RoI head pools at.
``roiaware_pool3d`` and ``roipoint_pool3d`` belong to PartA2 and PointRCNN
(ROADMAP.md, queue 1 items 4.1 and 4.3). Plain PyTorch, as the JAX module
is XLA."""

from __future__ import annotations

import torch


def roi_grid_points(rois, grid_size=6):
    """Global xyz of the centres of each RoI's G x G x G grid cells: rois
    [R, 7] -> [R, G^3, 3], cells in (i, j, k) row-major order over the
    box's (dx, dy, dz), rotated by the heading about the centre."""
    g = grid_size
    r = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    local = ((idx.to(rois.dtype) + 0.5) / g - 0.5)[None] * rois[:, None, 3:6]
    c, s = torch.cos(rois[:, 6])[:, None], torch.sin(rois[:, 6])[:, None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy, local[..., 2]], dim=-1) + rois[:, None, 0:3]
