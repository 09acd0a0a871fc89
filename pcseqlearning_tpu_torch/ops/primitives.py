"""Geometric primitive fitting (counterpart of
pcseqlearning_tpu.ops.primitives): per-voxel IRLS plane fits over segment
sums and the closed-form ``eigh3x3``, and the voxel neighbourhood graph
over the hashed coordinate table.
"""

from __future__ import annotations

import itertools

import torch

from . import geometry, grid_utils, hash_graph, segment_ops


def _fit(xyz, w, pidx, P):
    """One weighted fit: voxel centres, each point's offset from its
    voxel's centre, the covariance's eigenvalues and eigenvectors, and each
    point's distance to its voxel's plane."""
    rows = torch.clamp(pidx, 0, P - 1)
    center = segment_ops.weighted_segment_mean(xyz, w, pidx, P + 1)[:P]
    d = xyz - segment_ops.take_rows(center, rows)
    ddT = (w[:, None, None] * d[:, :, None]) * d[:, None, :]
    cov = segment_ops.segment_mean(ddT, pidx, P + 1)[:P]
    vals, vecs = geometry.eigh3x3(cov)
    err = torch.abs((d * segment_ops.take_rows(vecs[..., 0], rows)).sum(-1))
    return center, vals, vecs, err


def primitive_fitting(point_bxyz, point_valid, voxel_size, num_primitives, sigma=0.05,
                      num_iters=10):
    """Fit a plane per voxel by IRLS weighted PCA, as the JAX function does.

    Voxels are the distinct (b, cx, cy, cz) cells of the valid points
    (cells counted from the table's own minimum corner), in lexicographic
    order, at most ``num_primitives``. Weights start at the validity mask;
    each iteration refits and sets w = sigma^2 / (err^2 + sigma^2). The
    loop stops after the first iteration whose largest weight change is
    below 1e-2, or after ``num_iters``: it runs ``num_iters`` times with
    the update masked once it has stopped, so it reads nothing back to the
    host. Returns dict(centers [P, 3], normals [P, 3], eigvals [P, 3],
    eigvecs [P, 3, 3], weight_sum [P], point_weight [N], point_error [N],
    inverse [N], valid [P], num_iters_run, a device int: the iterations
    JAX's while-loop runs)."""
    P = int(num_primitives)
    dev = point_bxyz.device
    coords = grid_utils.voxel_coords(point_bxyz, voxel_size)
    coords = torch.where(point_valid[:, None], coords, torch.full_like(coords, 2 ** 24))
    inverse, _, _ = grid_utils.unique_rows(coords)
    pidx = torch.where(point_valid, inverse, torch.full_like(inverse, P))
    xyz = point_bxyz[:, 1:4]
    sigma2 = sigma * sigma
    w = point_valid.to(xyz.dtype)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    ran = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(num_iters):
        err = _fit(xyz, w, pidx, P)[3]
        new_w = sigma2 / (err * err + sigma2)
        step_done = torch.abs(new_w - w).max() < 1e-2 if w.numel() else torch.ones_like(done)
        w = torch.where(done, w, new_w)
        ran = ran + (~done).to(torch.int64)
        done = done | step_done
    center, vals, vecs, err = _fit(xyz, w, pidx, P)
    wsum = segment_ops.segment_count(pidx, P + 1, weights=w)[:P]
    return dict(centers=center, normals=vecs[..., 0], eigvals=vals, eigvecs=vecs,
                weight_sum=wsum, point_weight=w, point_error=err, inverse=inverse,
                valid=wsum > 1e-3, num_iters_run=ran)


def voxel_graph(coords, valid, kernel_offset=1):
    """Edges from each voxel to the valid voxels at every offset of its
    +-``kernel_offset`` neighbourhood but itself: (e_src [V * K], e_dst
    [V * K], -1 where none, mask), K = (2 k + 1)^3 - 1, offset-major."""
    table = hash_graph.build_coord_table(coords, valid)
    offs = [o for o in itertools.product(*[range(-kernel_offset, kernel_offset + 1)] * 3)
            if o != (0, 0, 0)]
    v = coords.shape[0]
    src = torch.arange(v, dtype=torch.int64, device=coords.device)
    srcs, dsts, masks = [], [], []
    for o in offs:
        q = coords.clone()
        q[:, 1:4] += torch.tensor(o, dtype=coords.dtype, device=coords.device)
        idx = hash_graph.coord_lookup(table, q, valid)
        srcs.append(src)
        dsts.append(idx)
        masks.append(idx >= 0)
    return torch.cat(srcs), torch.cat(dsts), torch.cat(masks)
