"""KPConv point backbone (counterpart of
pcseqlearning_tpu.models.backbones_kpconv): an encoder of grid-subsampled
KPConv dual blocks over hash-grid radius neighbourhoods, and a 3-NN
feature-propagation decoder back to the points.

Every level keeps the whole [N] table with a validity mask (the voxel
representatives), as the JAX network does. The 3-NN interpolations run
over the whole table with each sample shifted by 1e4 times its batch index
along x, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import grid_utils, hash_graph, sampling, segment_ops
from .blocks import KPConvBlock, _rows
from .layers import MaskedBatchNorm
from .vfe import linear


def _grid_reps(bxyz, valid, cell):
    """Voxel-mean representatives in place: ([N, 3] the mean xyz of each
    point's voxel of side ``cell``, the validity of the representatives
    (the first valid row of each voxel), inverse [N])."""
    n = bxyz.shape[0]
    coords = grid_utils.voxel_coords(bxyz, [cell, cell, cell])
    coords = torch.where(valid[:, None], coords, torch.full_like(coords, 2 ** 24))
    inverse, _, _ = grid_utils.unique_rows(coords)
    inv_safe = torch.where(valid, inverse, torch.full_like(inverse, n))
    mean_xyz = segment_ops.segment_mean(
        torch.where(valid[:, None], bxyz[:, 1:4], bxyz.new_zeros(())), inv_safe, n + 1)[:n]
    rows = torch.arange(n, device=bxyz.device)
    first = segment_ops.segment_min_or(rows, inv_safe, n + 1, n)[:n]
    return mean_xyz[inverse], valid & (rows == first[inverse]), inverse


def pool_to_reps(x, lvalid, inverse):
    """Each row's voxel mean of the valid rows' features ``x``."""
    n = x.shape[0]
    seg = torch.where(lvalid, inverse, torch.full_like(inverse, n))
    pooled = segment_ops.segment_mean(torch.where(lvalid[:, None], x, x.new_zeros(())), seg,
                                      n + 1)[:n]
    return _rows(pooled, inverse)


def level_neighbours(bidx, xyz, lvalid, radius, nsample):
    """The ``nsample`` nearest valid representatives within ``radius`` of
    each representative, in its own sample (hash grid keyed by batch)."""
    ref = torch.cat([bidx[:, None], xyz], dim=1)
    grid = hash_graph.build_hash_grid(ref, radius, lvalid)
    nbr, _, nmask = hash_graph.radius_neighbors(grid, ref, radius, nsample, query_valid=lvalid,
                                                cell_cap=nsample + 16)
    return nbr, nmask


def interpolate3(up_xyz, up_valid, up_x, f_xyz, shift):
    """Inverse-distance weights of the 3 nearest valid coarse rows (1 /
    max(d^2, 1e-8), normalised) over the whole shifted table, applied to
    their features."""
    idx, d2 = sampling.knn_bruteforce(up_xyz + shift, f_xyz + shift, 3, ref_valid=up_valid)
    w = 1.0 / torch.clamp(d2, min=1e-8)
    w = w / w.sum(dim=1, keepdim=True)
    return (_rows(up_x, idx) * w[..., None].to(up_x.dtype)).sum(1)


def decode(net, levels, pts, valid, shift):
    """The feature-propagation decoder that KPConvNet and GraphConvNet
    share: up each level (3-NN interpolation joined to the finer level's
    features, ``up<l>`` linear, ``up<l>_bn``, ReLU), then back to the raw
    points (``head``, ``head_bn``, ReLU; zero for points not valid). The
    layers sit on ``net`` under JAX's names (``add_decoder``)."""
    up_xyz, up_valid, up_x = levels[-1]
    for li in range(len(levels) - 2, -1, -1):
        f_xyz, f_valid, f_x = levels[li]
        up_x = torch.cat([f_x, interpolate3(up_xyz, up_valid, up_x, f_xyz, shift)], dim=-1)
        up_x = torch.relu(getattr(net, f"up{li}_bn")(getattr(net, f"up{li}")(up_x), f_valid))
        up_xyz, up_valid = f_xyz, f_valid
    point_x = interpolate3(up_xyz, up_valid, up_x, pts[:, 1:4], shift)
    point_x = torch.relu(net.head_bn(net.head(point_x), valid))
    return torch.where(valid[:, None], point_x, point_x.new_zeros(()))


def add_decoder(net, channels, out_channels, generator):
    for li in range(len(channels) - 2, -1, -1):
        setattr(net, f"up{li}", linear(channels[li] + channels[li + 1], channels[li],
                                       generator=generator))
        setattr(net, f"up{li}_bn", MaskedBatchNorm(channels[li]))
    net.head = linear(channels[0], out_channels, generator=generator)
    net.head_bn = MaskedBatchNorm(out_channels)


class KPConvNet(nn.Module):
    """Encoder-decoder KPConv network producing per-point features
    (``point_features`` [N, out_channels], zero for points not valid, and
    ``point_coords`` [N, 4]). Level l subsamples to voxel means at
    ``base_cell`` * 2^l and runs two ``KPConvBlock`` (``kp<l>a``,
    ``kp<l>b``, sigma the cell, neighbours within 2.5 cells) joined by a
    residual ReLU. ``cin`` is the width of ``point_feat`` (a ones column is
    added)."""

    def __init__(self, cin=1, channels=(64, 128, 256), base_cell=0.1, nsample=16,
                 out_channels=64, generator=None):
        super().__init__()
        self.channels, self.base_cell, self.nsample = tuple(channels), base_cell, nsample
        c = cin + 1
        for li, ch in enumerate(self.channels):
            cell = base_cell * (2 ** li)
            setattr(self, f"kp{li}a", KPConvBlock(c, ch, sigma=cell, generator=generator))
            setattr(self, f"kp{li}b", KPConvBlock(ch, ch, sigma=cell, generator=generator))
            c = ch
        add_decoder(self, self.channels, out_channels, generator)
        self.out_channels = out_channels

    def forward(self, batch_dict):
        pts = batch_dict["point_bxyz"]
        n = pts.shape[0]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=pts.device)
        feats = batch_dict.get("point_feat")
        if feats is None:
            feats = pts.new_zeros((n, 1))
        dt = self.head.weight.dtype
        bidx = torch.round(pts[:, 0])
        x = torch.cat([feats, torch.ones_like(feats[:, :1])], dim=-1).to(dt)
        xyz, lvalid, levels = pts[:, 1:4], valid, []
        for li in range(len(self.channels)):
            cell = self.base_cell * (2 ** li)
            rep_xyz, rep_valid, inverse = _grid_reps(torch.cat([bidx[:, None], xyz], 1),
                                                     lvalid, cell)
            x = pool_to_reps(x, lvalid, inverse)
            xyz, lvalid = rep_xyz, rep_valid
            nbr, nmask = level_neighbours(bidx, xyz, lvalid, 2.5 * cell, self.nsample)
            x = getattr(self, f"kp{li}a")(x, xyz.to(dt), nbr, nmask, lvalid)
            y = getattr(self, f"kp{li}b")(x, xyz.to(dt), nbr, nmask, lvalid)
            x = torch.relu(x + y)  # the residual dual block
            levels.append((xyz, lvalid, x))
        shift = torch.zeros_like(pts[:, 1:4])
        shift[:, 0] = 1e4 * bidx
        batch_dict["point_features"] = decode(self, levels, pts, valid, shift)
        batch_dict["point_coords"] = torch.cat([pts[:, 0:1], pts[:, 1:4]], dim=1)
        return batch_dict
