"""Point feature extraction (counterpart of pcseqlearning_tpu.models.pfe):
``VoxelSetAbstraction``, PV-RCNN's keypoint branch, its two aggregations
(``SAGroup``, ball query + shared MLP + max; ``VectorPoolAggregation``,
PV-RCNN++'s local-voxel vector pooling), and ``voxel_centers``.

The neighbour searches are the hash grid of ``ops.hash_graph`` on float32
(batch index, x, y, z) rows, as the JAX modules run it: the batch index is
the first coordinate, the scan cap nsample + 16 a probe. Every gather that
carries a gradient goes through ``segment_ops.take_rows`` (its backward is
reproducible on the card), and a max over samples is ``amax``, which
splits a tie's gradient evenly, as ``jnp.max``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import hash_graph, sampling, segment_ops
from .layers import MaskedBatchNorm, init_fan_in
from .vfe import linear


def voxel_centers(coords_bzyx, valid, voxel_size, pc_range_min, stride):
    """[V, 3] xyz centres of (strided) voxel coords (b, z, y, x): cell + 0.5
    times the voxel size times ``stride``, from the range's minimum
    corner."""
    dev = coords_bzyx.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    origin = torch.tensor(pc_range_min, dtype=torch.float32, device=dev)
    xyz = coords_bzyx[:, 1:4].flip(-1).to(torch.float32)
    return (xyz + 0.5) * vs[None, :] + origin[None, :]


def _ball_query(key_xyz, key_batch, src_xyz, src_batch, src_valid, radius, nsample):
    """(idx [K, S] clipped into the table, mask [K, S]): each key's nsample
    nearest sources of its own sample within ``radius``, searched on
    float32 rows (batch, x, y, z) as the JAX modules do."""
    src_f = torch.cat([src_batch[:, None].to(torch.float32),
                       src_xyz.detach().to(torch.float32)], dim=1)
    key_f = torch.cat([key_batch[:, None].to(torch.float32),
                       key_xyz.detach().to(torch.float32)], dim=1)
    grid = hash_graph.build_hash_grid(src_f, radius, src_valid)
    idx, _, mask = hash_graph.radius_neighbors(grid, key_f, radius, nsample,
                                               cell_cap=nsample + 16)
    return torch.clamp(idx, 0, max(src_xyz.shape[0] - 1, 0)), mask


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


class SAGroup(nn.Module):
    """One set-abstraction group (pointnet2_stack QueryAndGroup + MLP):
    each key's ``nsample`` sources within ``radius``, their offsets from the
    key and their features through linear (no bias), ``MaskedBatchNorm``
    over the found samples and ReLU per layer, then a max over the samples
    (0 for a key with none). ``cin`` is the source features' width."""

    def __init__(self, cin, radius, nsample, mlp, generator=None):
        super().__init__()
        self.radius, self.nsample, self.num_layers = radius, nsample, len(mlp)
        c = 3 + cin
        for i, cout in enumerate(mlp):
            setattr(self, f"linear{i}", linear(c, cout, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(cout))
            c = cout

    def forward(self, key_xyz, key_batch, src_xyz, src_batch, src_feats, src_valid):
        nk, s = key_xyz.shape[0], self.nsample
        idx, mask = _ball_query(key_xyz, key_batch, src_xyz, src_batch, src_valid,
                                self.radius, s)
        flat = idx.reshape(-1)
        rel = src_xyz[flat].reshape(nk, s, 3).to(key_xyz.dtype) - key_xyz[:, None, :]
        gf = segment_ops.take_rows(src_feats, flat).reshape(nk, s, -1)
        x = torch.where(mask[..., None], torch.cat([rel.to(gf.dtype), gf], dim=-1), _zero(gf))
        h, m = x.reshape(nk * s, -1), mask.reshape(-1)
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(h), m))
        h = h.reshape(nk, s, -1)
        out = torch.where(mask[..., None], h, torch.full_like(h, float("-inf"))).amax(dim=1)
        return torch.where(mask.any(dim=1)[:, None], out, _zero(out))


def vector_pool_bin(rel_xyz, feats, mask, num_voxels, max_dist):
    """Local-voxel average pooling of a neighbourhood (the voxel_avg_pool
    path of the reference VectorPoolAggregationModule): each query's cube
    of half-edge ``max_dist`` (strictly inside on every axis) is split into
    nx * ny * nz voxels (floor, clipped), and the samples' offsets and
    features average per voxel.

    rel_xyz [M, K, 3], feats [M, K, C], mask [M, K] -> (pooled [M, V, 3 + C],
    0 where empty; occupied [M, V])."""
    m, k, c = feats.shape
    nx, ny, nz = num_voxels
    V = nx * ny * nz
    dt, dev = rel_xyz.dtype, rel_xyz.device
    d = torch.tensor(max_dist, dtype=dt, device=dev)
    inside = (rel_xyz.abs() < d).all(dim=-1) & mask
    cell_size = 2.0 * d / torch.tensor([nx, ny, nz], dtype=dt, device=dev)
    cell = torch.floor((rel_xyz + d) / cell_size).long()
    cell = torch.minimum(torch.clamp(cell, min=0),
                         torch.tensor([nx - 1, ny - 1, nz - 1], device=dev))
    vid = (cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2]
    key = torch.where(inside, torch.arange(m, device=dev)[:, None] * V + vid,
                      torch.full_like(vid, m * V)).reshape(-1)
    flat = torch.cat([rel_xyz, feats.to(dt)], dim=-1).reshape(m * k, -1)
    w = inside.to(dt).reshape(-1)
    sums = segment_ops.segment_sum(flat * w[:, None], key, m * V)
    cnts = segment_ops.segment_sum(w, key, m * V)
    pooled = (sums / torch.clamp(cnts, min=1.0)[:, None]).reshape(m, V, 3 + c)
    occ = cnts.reshape(m, V) > 0.5
    return torch.where(occ[..., None], pooled, _zero(pooled)), occ


class VectorPoolAggregation(nn.Module):
    """Vector-pool aggregation (reference VectorPoolAggregationModule,
    voxel_avg_pool): the sources' features reduced by a linear
    (``reduce``), each key's ``neighbor_nsample`` sources within
    max_neighbor_distance * sqrt(3) (rows not found get offset 1e8),
    ``vector_pool_bin`` over the cube, a per-voxel linear (``group_kernel``
    [V, 3 + reduced, local], an einsum; TF32 must be off on the card for
    float32 products), then ``group_bn`` and the post MLP, each masked by
    whether any voxel of the key is occupied."""

    def __init__(self, cin, num_local_voxel=(3, 3, 3), max_neighbor_distance=1.2,
                 neighbor_nsample=32, num_reduced_channels=30,
                 num_channels_of_local_aggregation=32, post_mlps=(128,), generator=None):
        super().__init__()
        self.num_local_voxel = tuple(num_local_voxel)
        self.max_neighbor_distance, self.neighbor_nsample = max_neighbor_distance, neighbor_nsample
        self.num_post = len(post_mlps)
        v = math.prod(self.num_local_voxel)
        cg = 3 + num_reduced_channels
        self.reduce = linear(cin, num_reduced_channels, generator=generator)
        self.group_kernel = nn.Parameter(init_fan_in(
            torch.empty(v, cg, num_channels_of_local_aggregation), v * cg, generator))
        c = v * num_channels_of_local_aggregation
        self.group_bn = MaskedBatchNorm(c)
        for i, cout in enumerate(post_mlps):
            setattr(self, f"post{i}", linear(c, cout, generator=generator))
            setattr(self, f"post_bn{i}", MaskedBatchNorm(cout))
            c = cout

    def forward(self, key_xyz, key_batch, src_xyz, src_batch, src_feats, src_valid):
        nk, s = key_xyz.shape[0], self.neighbor_nsample
        d = self.max_neighbor_distance
        idx, mask = _ball_query(key_xyz, key_batch, src_xyz, src_batch, src_valid,
                                d * 1.7320508, s)
        flat = idx.reshape(-1)
        rel = src_xyz[flat].reshape(nk, s, 3).to(key_xyz.dtype) - key_xyz[:, None, :]
        rel = torch.where(mask[..., None], rel, torch.full_like(rel, 1e8))
        feats = self.reduce(src_feats)
        gf = segment_ops.take_rows(feats, flat).reshape(nk, s, -1)
        gf = torch.where(mask[..., None], gf, _zero(gf))
        pooled, occ = vector_pool_bin(rel.to(gf.dtype), gf, mask, self.num_local_voxel, d)
        h = torch.einsum("mvc,vcd->mvd", pooled, self.group_kernel).reshape(nk, -1)
        any_occ = occ.any(dim=1)
        h = torch.relu(self.group_bn(h, any_occ))
        for i in range(self.num_post):
            h = torch.relu(getattr(self, f"post_bn{i}")(getattr(self, f"post{i}")(h), any_occ))
        return torch.where(any_occ[:, None], h, _zero(h))


class VoxelSetAbstraction(nn.Module):
    """PV-RCNN's keypoint branch: ``num_keypoints`` FPS keypoints a sample
    over its valid raw points, then per keypoint, concatenated in this
    order: the raw points' group (radius 0.4, MLP (16, 16)), the x_conv3 and
    x_conv4 voxel tables' groups (1.2 and 2.4, MLP (32, 32)), the BEV map
    sampled bilinearly; then linear (no bias) to 128 channels,
    ``MaskedBatchNorm`` over all keypoints and ReLU. ``aggregation`` "sa"
    groups by ``SAGroup`` (``sa_<source>``), "vector_pool" by
    ``VectorPoolAggregation`` (``vp_<source>``, the MLP as its post MLP).

    ``source_channels`` gives x_conv3's and x_conv4's widths, ``raw_channels``
    the points' feature width, ``bev_channels`` the BEV map's. Writes
    ``point_features`` [B * K, 128], ``point_coords`` [B * K, 4] (batch,
    x, y, z) and ``keypoint_indices`` [B * K], the FPS picks' rows."""

    STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
    RADII = {"raw_points": (0.4, 16), "x_conv3": (1.2, 16), "x_conv4": (2.4, 16)}
    # the JAX module's defaults, which no config changes
    FEATURES_SOURCE, OUT_CHANNELS = ("bev", "x_conv3", "x_conv4", "raw_points"), 128

    def __init__(self, voxel_size, point_cloud_range, num_keypoints=2048,
                 source_channels=None, raw_channels=1, bev_channels=256, aggregation="sa",
                 generator=None):
        super().__init__()
        self.voxel_size, self.point_cloud_range = tuple(voxel_size), tuple(point_cloud_range)
        self.num_keypoints, self.aggregation = int(num_keypoints), aggregation
        self.out_channels = self.OUT_CHANNELS
        source_channels = source_channels or {"x_conv3": 64, "x_conv4": 64}
        self.groups = []  # (source, module name), in the concatenation's order
        width = self._add_group("raw", "raw_points", raw_channels, (16, 16), generator)
        for src in self.FEATURES_SOURCE:
            if src in self.STRIDES:
                width += self._add_group(src, src, source_channels[src], (32, 32), generator)
        self.linear0 = linear(width + bev_channels, self.OUT_CHANNELS, generator=generator)
        self.norm0 = MaskedBatchNorm(self.OUT_CHANNELS)

    def _add_group(self, name, src, cin, mlp, generator):
        r, ns = self.RADII.get(src, (1.6, 16))
        if self.aggregation == "vector_pool":
            mod, prefix = VectorPoolAggregation(cin, max_neighbor_distance=r, neighbor_nsample=ns,
                                                post_mlps=mlp, generator=generator), "vp_"
        else:
            mod, prefix = SAGroup(cin, r, ns, mlp, generator=generator), "sa_"
        setattr(self, prefix + name, mod)
        self.groups.append((src, prefix + name))
        return mlp[-1]

    def _bev(self, bev, key_xyz, key_b, stride):
        """Bilinear samples [K, C] of the NCHW map ``bev`` at the keypoints'
        cells (x0, y0 clipped to [0, W - 2] and [0, H - 2], weights to [0,
        1]), gathered through one reproducible gather."""
        dt, dev = key_xyz.dtype, key_xyz.device
        pcr = torch.tensor(self.point_cloud_range, dtype=dt, device=dev)
        vs = torch.tensor(self.voxel_size, dtype=dt, device=dev)
        fx = (key_xyz[:, 0] - pcr[0]) / (vs[0] * stride) - 0.5
        fy = (key_xyz[:, 1] - pcr[1]) / (vs[1] * stride) - 0.5
        b, c, H, W = bev.shape
        x0 = torch.clamp(torch.floor(fx).long(), 0, W - 2)
        y0 = torch.clamp(torch.floor(fy).long(), 0, H - 2)
        one = torch.ones((), dtype=dt, device=dev)
        wx = torch.minimum(torch.clamp(fx - x0, min=0), one)[:, None].to(bev.dtype)
        wy = torch.minimum(torch.clamp(fy - y0, min=0), one)[:, None].to(bev.dtype)
        rows = bev.permute(0, 2, 3, 1).reshape(b * H * W, c)
        base = (key_b * H + y0) * W + x0
        k = key_xyz.shape[0]
        f00, f01, f10, f11 = segment_ops.take_rows(
            rows, torch.cat([base, base + 1, base + W, base + W + 1])).reshape(4, k, c)
        return (f00 * (1 - wx) * (1 - wy) + f01 * wx * (1 - wy) + f10 * (1 - wx) * wy
                + f11 * wx * wy)

    def forward(self, batch_dict):
        points = batch_dict["point_bxyz"]
        n, dev = points.shape[0], points.device
        p_valid = batch_dict.get("point_valid")
        if p_valid is None:
            p_valid = torch.ones(n, dtype=torch.bool, device=dev)
        batch_size, k = int(batch_dict["batch_size"]), self.num_keypoints
        bidx = torch.round(points[:, 0]).long()
        masks = (bidx[None, :] == torch.arange(batch_size, device=dev)[:, None]) & p_valid
        # the picks are made on the float32 points, as the data are float32
        picks = sampling.batched_farthest_point_sample(points[:, 1:4].float(), k,
                                                       masks).reshape(-1)
        key_xyz = points[picks, 1:4]
        key_b = torch.arange(batch_size, device=dev).repeat_interleave(k)
        ms = batch_dict.get("multi_scale_3d_features", {})
        feats = []
        for src, name in self.groups:
            group = getattr(self, name)
            if src == "raw_points":
                raw_f = batch_dict.get("point_feat")
                if raw_f is None:
                    raw_f = points.new_zeros((n, 1))
                feats.append(group(key_xyz, key_b, points[:, 1:4], bidx, raw_f, p_valid))
            elif src in ms:
                st = ms[src]
                centers = voxel_centers(st.coords, st.valid, self.voxel_size,
                                        self.point_cloud_range[:3], self.STRIDES[src])
                feats.append(group(key_xyz, key_b, centers, st.coords[:, 0].long(), st.features,
                                   st.valid))
        if "spatial_features" in batch_dict:
            feats.append(self._bev(batch_dict["spatial_features"], key_xyz, key_b,
                                   batch_dict.get("spatial_features_stride", 8)))
        kp = self.linear0(torch.cat(feats, dim=-1))
        kp = torch.relu(self.norm0(kp, torch.ones(kp.shape[0], dtype=torch.bool, device=dev)))
        batch_dict["point_features"] = kp
        batch_dict["point_coords"] = torch.cat([key_b[:, None].to(key_xyz.dtype), key_xyz], dim=1)
        batch_dict["keypoint_indices"] = picks
        return batch_dict
