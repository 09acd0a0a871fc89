"""RoI pooling (counterpart of pcseqlearning_tpu.ops.roi_pool): the RoI
grid that Voxel R-CNN's and PV-RCNN's heads pool at, RoI-aware voxel
pooling (PartA2's head) and RoI point pooling (PointRCNN's head). Plain
PyTorch, as the JAX module is XLA.
"""

from __future__ import annotations

import torch

from . import segment_ops

# RoIs per chunk of roiaware_pool3d's [R, N] inside test: 16 x 320,000
# points is ~60 MB of float32 canonical coordinates a chunk
_ROI_CHUNK = 16


def _true_div(x, c):
    """x / c for a Python number c, divided as on the CPU: on the card a
    tensor divided by a Python number is multiplied by its reciprocal,
    which can round the last bit otherwise (and move a point across a
    cell boundary)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def roi_grid_points(rois, grid_size=6):
    """Global xyz of the centres of each RoI's G x G x G grid cells: rois
    [R, 7] -> [R, G^3, 3], cells in (i, j, k) row-major order over the
    box's (dx, dy, dz), rotated by the heading about the centre."""
    g = grid_size
    r = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    local = (_true_div(idx.to(rois.dtype) + 0.5, g) - 0.5)[None] * rois[:, None, 3:6]
    c, s = torch.cos(rois[:, 6])[:, None], torch.sin(rois[:, 6])[:, None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy, local[..., 2]], dim=-1) + rois[:, None, 0:3]


def _to_local(points_xyz, rois):
    """[R, N, 3] coordinates of each point in each RoI's canonical frame
    (centred on the RoI, rotated by minus its heading)."""
    d = points_xyz[None, :, :] - rois[:, None, 0:3]
    c = torch.cos(-rois[:, 6])[:, None]
    s = torch.sin(-rois[:, 6])[:, None]
    lx = d[..., 0] * c + d[..., 1] * (-s)
    ly = d[..., 0] * s + d[..., 1] * c
    return torch.stack([lx, ly, d[..., 2]], dim=-1)


def roiaware_pool3d(points_xyz, point_feats, rois, point_valid=None, roi_valid=None,
                    grid_size=6, pool="max"):
    """RoI-aware grid pooling: each valid point strictly inside a valid RoI
    (|local| < half size + 1e-6 on every axis) falls into one of the RoI's
    G x G x G cells (floor, clipped to the grid), and each cell pools its
    points' features by ``pool``, "max" or "avg" (0 where empty).

    Every point of the table is tested against every RoI, whatever sample
    either belongs to: the JAX function takes no batch index. Only the
    (RoI, point) pairs inside reach the reduction, RoIs in chunks of
    ``_ROI_CHUNK``; the pairs keep the dense [R, N] order, so each cell sums
    its points in ascending point order, as the JAX function's segment sum
    over the [R * N] table does. The RoIs enter through discrete cells only
    (no gradient); the features' gradient is a reproducible gather.

    Args: points_xyz [N, 3]; point_feats [N, C]; rois [R, 7]; point_valid
    [N] and roi_valid [R] bool (default all valid).
    Returns: pooled [R, G, G, G, C]; occupancy [R, G, G, G] bool."""
    n, r, g = points_xyz.shape[0], rois.shape[0], grid_size
    dev = points_xyz.device
    if point_valid is None:
        point_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if roi_valid is None:
        roi_valid = torch.ones(r, dtype=torch.bool, device=dev)
    rois = rois.detach()
    keys, rows = [], []
    for r0 in range(0, r, _ROI_CHUNK):
        rc = rois[r0:r0 + _ROI_CHUNK]
        local = _to_local(points_xyz.detach(), rc)  # [Rc, N, 3]
        half = rc[:, None, 3:6] / 2.0
        inside = (local.abs() < half + 1e-6).all(dim=-1)
        inside = inside & point_valid[None, :] & roi_valid[r0:r0 + _ROI_CHUNK, None]
        ri, pi = torch.nonzero(inside, as_tuple=True)  # row-major: (RoI, point) order
        cell = torch.floor((local[ri, pi] + half[ri, 0]) / _true_div(rc[ri, 3:6], g)).long()
        cell = torch.clamp(cell, 0, g - 1)
        keys.append((((ri + r0) * g + cell[:, 0]) * g + cell[:, 1]) * g + cell[:, 2])
        rows.append(pi)
    key, row = torch.cat(keys), torch.cat(rows)
    num = r * g ** 3
    feats = segment_ops.take_rows(point_feats, row)
    if pool == "max":
        pooled = segment_ops.segment_max_or(feats, key, num, 0.0)
    else:
        pooled = segment_ops.segment_mean(feats, key, num)
    occ = segment_ops.segment_count(key, num) > 0.5
    c = point_feats.shape[-1]
    return pooled.reshape(r, g, g, g, c), occ.reshape(r, g, g, g)


def _first_inside(inside, num_sampled):
    """Each row's first ``num_sampled`` True columns of inside [R, N] in
    index order, the rest filled with the row's first (with N - 1 where a
    row has none): [R, S] int64. Any ascending selection of the inside
    columns is the JAX function's sort of their indices, so the ranks come
    from a cumulative count rather than a sort."""
    r, n = inside.shape
    rank = torch.cumsum(inside.to(torch.int32), dim=1) - 1
    ri, pi = torch.nonzero(inside & (rank < num_sampled), as_tuple=True)
    picked = torch.full((r, num_sampled), n, dtype=torch.int64, device=inside.device)
    picked[ri, rank[ri, pi].long()] = pi
    first = torch.clamp(picked[:, :1], max=n - 1)
    return torch.where(picked < n, picked, first)


def _pool_points(points_xyz, point_feats, inside, num_sampled):
    """(pooled [R, S, 3 + C] rows of [xyz, feats] for ``_first_inside``,
    empty [R]); the gather carries the gradient reproducibly."""
    r = inside.shape[0]
    picked = _first_inside(inside, num_sampled)
    feats = torch.cat([points_xyz, point_feats.to(points_xyz.dtype)], dim=-1)
    pooled = segment_ops.take_rows(feats, picked.reshape(-1)).reshape(r, num_sampled, -1)
    return pooled, ~inside.any(dim=1)


def _inside(points_xyz, rois):
    """[R, N]: each point strictly inside each RoI (|local| < half size +
    1e-6 on every axis, as the JAX functions test), no gradient."""
    rois = rois.detach()
    local = _to_local(points_xyz.detach(), rois)
    return (local.abs() < rois[:, None, 3:6] / 2.0 + 1e-6).all(dim=-1)


def roipoint_pool3d(points_xyz, point_feats, rois, num_sampled=512, point_valid=None):
    """Each RoI's first ``num_sampled`` valid points inside it, in index
    order, as rows [x, y, z, features], the rest filled with its first such
    point; an empty RoI gives zeros and empty = True.

    Args: points_xyz [N, 3]; point_feats [N, C]; rois [R, 7]; point_valid
    [N] bool (default all valid).
    Returns: pooled [R, S, 3 + C]; empty [R] bool."""
    inside = _inside(points_xyz, rois)
    if point_valid is not None:
        inside = inside & point_valid[None, :]
    pooled, empty = _pool_points(points_xyz, point_feats, inside, num_sampled)
    return torch.where(empty[:, None, None], pooled.new_zeros(()), pooled), empty


def roipoint_pool3d_masked(points_xyz, point_feats, rois, pair_valid, num_sampled=512):
    """``roipoint_pool3d`` with a mask pair_valid [R, N] of the (RoI, point)
    pairs that may pool (PointRCNN's head: each RoI's own sample), and the
    pooled xyz centred on the RoI (its centre subtracted, which carries the
    gradient into the RoIs); an empty RoI gives zeros.

    Returns: pooled [R, S, 3 + C]; empty [R] bool."""
    pooled, empty = _pool_points(points_xyz, point_feats,
                                 _inside(points_xyz, rois) & pair_valid, num_sampled)
    pooled = torch.cat([pooled[..., :3] - rois[:, None, 0:3], pooled[..., 3:]], dim=-1)
    return torch.where(empty[:, None, None], pooled.new_zeros(()), pooled), empty
