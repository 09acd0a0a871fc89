"""Voxel-grid utilities (counterpart of pcseqlearning_tpu.ops.grid_utils):
lexicographic multi-key unique, per-voxel mean grid sampling and the
one-point-per-voxel subsample."""

from __future__ import annotations

import torch

from . import segment_ops


def unique_rows(coords):
    """Group identical integer rows.

    Args:
        coords: [N, D] integer tensor.
    Returns:
        inverse [N] int64 — group id per row, ids in lexicographic row order;
        num_groups — python int; perm [N] — the lexicographic sort permutation.
    """
    n, d = coords.shape
    perm = segment_ops.lexsort([coords[:, i] for i in range(d)])
    sc = coords[perm]
    change = torch.zeros(n, dtype=torch.int64, device=coords.device)
    if n > 1:
        change[1:] = (sc[1:] != sc[:-1]).any(dim=1).to(torch.int64)
    group_of_sorted = torch.cumsum(change, 0)
    num_groups = int(group_of_sorted[-1]) + 1 if n else 0
    inverse = torch.empty(n, dtype=torch.int64, device=coords.device)
    inverse[perm] = group_of_sorted
    return inverse, num_groups, perm


def voxel_coords(points_bxyz, voxel_size):
    """Integer voxel coordinates [N, 4] = (batch/frame, cx, cy, cz), cells
    counted from the points' own minimum corner."""
    vs = torch.as_tensor(voxel_size, dtype=points_bxyz.dtype, device=points_bxyz.device)
    origin = points_bxyz[:, 1:4].min(dim=0).values
    b = torch.round(points_bxyz[:, 0]).to(torch.int32)
    cxyz = torch.floor((points_bxyz[:, 1:4] - origin) / vs).to(torch.int32)
    return torch.cat([b[:, None], cxyz], dim=1)


def grid_sample_mean(points_bxyz, voxel_size):
    """Voxel-grid downsample by per-voxel mean.

    Returns dict(bxyz [V, 4] per-voxel mean, valid [V], inverse [N],
    num_voxels int). The table holds exactly the V occupied voxels (the JAX
    version pads it to a static capacity), so it cannot overflow."""
    coords = voxel_coords(points_bxyz, voxel_size)
    inverse, num_voxels, _ = unique_rows(coords)
    return {
        "bxyz": segment_ops.segment_mean(points_bxyz, inverse, num_voxels),
        "valid": segment_ops.segment_count(inverse, num_voxels) > 0.5,
        "inverse": inverse,
        "num_voxels": num_voxels,
    }


def grid_subsample_indices(points_bxyz, voxel_size):
    """One representative point per voxel, the voxel's largest row index.

    Returns (rep [N] int64: rep[v] the chosen row of voxel v, -1 past the
    last voxel; valid [N] = rep >= 0; inverse [N]; num_voxels int)."""
    n = points_bxyz.shape[0]
    inverse, num_voxels, _ = unique_rows(voxel_coords(points_bxyz, voxel_size))
    rep = segment_ops.segment_max_or(torch.arange(n, device=points_bxyz.device), inverse, n, -1)
    return rep, rep >= 0, inverse, num_voxels


def dynamic_voxelize(points_bxyz, features, voxel_size, pc_range_min, num_voxels_cap):
    """Dynamic voxelization: the mean feature of every occupied voxel, no
    cap on the points per voxel.

    Voxels are numbered in lexicographic (b, cx, cy, cz) order; with more
    than ``num_voxels_cap`` occupied voxels the first ``num_voxels_cap`` are
    kept and the points of the others are dropped, as the JAX function's
    ``segment_*`` calls drop ids at or above the cap.

    Returns:
        voxel_coords [cap, 4] int32 (b, cz, cy, cx), the spconv layout
        voxel_feats  [cap, C] mean features
        valid        [cap] bool
        inverse      [N] int64, the voxel of each point (>= cap: dropped)
    """
    dev, dt = points_bxyz.device, points_bxyz.dtype
    vs = torch.as_tensor(voxel_size, dtype=dt, device=dev)
    origin = torch.as_tensor(pc_range_min, dtype=dt, device=dev)
    b = torch.round(points_bxyz[:, 0]).to(torch.int32)
    cxyz = torch.floor((points_bxyz[:, 1:4] - origin) / vs).to(torch.int32)
    coords = torch.cat([b[:, None], cxyz], dim=1)
    inverse, _, _ = unique_rows(coords)
    cap = num_voxels_cap
    feats = segment_ops.segment_mean(features, inverse, cap)
    valid = segment_ops.segment_count(inverse, cap) > 0.5
    vc = segment_ops.segment_min_or(coords, inverse, cap, 0)
    return torch.stack([vc[:, 0], vc[:, 3], vc[:, 2], vc[:, 1]], dim=1), feats, valid, inverse
