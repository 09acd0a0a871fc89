"""Dynamic voxel aggregation (counterpart of
pcseqlearning_tpu.ops.voxel_modules): the per-voxel mean of float features
and the median of integer labels, over grid_utils and segment_ops."""

from __future__ import annotations

import torch

from . import grid_utils, segment_ops


class VoxelAggregation:
    """Voxels of ``voxel_size`` over (b, x, y, z); a table of
    ``num_voxels_cap`` rows (default: one per point, as in JAX)."""

    def __init__(self, voxel_size, num_voxels_cap=None):
        self.voxel_size = [float(v) for v in voxel_size]
        self.num_voxels_cap = num_voxels_cap

    def __call__(self, point_bxyz, feature_dict=None, valid=None):
        """Returns dict(bxyz, valid, inverse, num_voxels, and for each entry
        of ``feature_dict`` the voxel mean of a float entry or the voxel
        median of an integer one). Points not valid move to 1e8 (their own
        voxel) and add to no entry's mean; an integer entry gives them -1,
        which enters the median as JAX's does."""
        n = point_bxyz.shape[0]
        cap = self.num_voxels_cap or n
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=point_bxyz.device)
        pts = torch.where(valid[:, None], point_bxyz, torch.full_like(point_bxyz, 1e8))
        out = grid_utils.grid_sample_mean(pts, self.voxel_size, num_voxels_cap=cap)
        inverse = out["inverse"]
        inv_safe = torch.where(valid, inverse, torch.full_like(inverse, cap))
        for k, v in (feature_dict or {}).items():
            v = torch.as_tensor(v, device=point_bxyz.device)
            if not v.dtype.is_floating_point:
                out[k] = segment_ops.segment_median(
                    torch.where(valid, v, torch.full_like(v, -1)), inverse, cap)
            else:
                m = valid[:, None] if v.dim() > 1 else valid
                out[k] = segment_ops.segment_mean(torch.where(m, v, torch.zeros_like(v)),
                                                  inv_safe, cap + 1)[:cap]
        return out
