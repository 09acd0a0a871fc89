"""Point-graph backbone family (counterpart of
pcseqlearning_tpu.models.backbones_graph): PointConvNet, VolumeConvNet,
PointGroupNet, PointPlaneNet and PointNet2RepSurf, one grid-pyramid encoder
and 3-NN decoder (KPConvNet's) whose variant picks the edge message:

  PointConvNet     a weight net over the offsets gates the projected
                   neighbour features, averaged
  VolumeConvNet    the same, with the offsets whitened by the
                   neighbourhood's covariance eigenvalues joining its input
  PointGroupNet    MLP([offset, feature]) and max, fused with the centre
  PointPlaneNet    the neighbourhood plane normal and point-to-plane
                   distances join the MLP's input, max
  PointNet2RepSurf MLP and max, with umbrella surface descriptors joining
                   the point features
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import geometry
from .backbones_kpconv import _grid_reps, add_decoder, decode, level_neighbours, pool_to_reps
from .blocks import _rows
from .layers import MaskedBatchNorm
from .vfe import linear

VARIANTS = ("PointConvNet", "VolumeConvNet", "PointGroupNet", "PointPlaneNet", "PointNet2RepSurf")


def _neighborhood_cov_eig(rel, nbr_mask):
    """Eigenvalues (ascending) and eigenvectors (columns) of each
    neighbourhood's offset covariance; rel [N, K, 3], nbr_mask [N, K]."""
    w = nbr_mask.to(rel.dtype)[..., None]
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (rel * w).sum(1) / cnt
    c = torch.where(nbr_mask[..., None], rel - mean[:, None, :], rel.new_zeros(()))
    cov = (c[..., :, None] * c[..., None, :]).sum(1) / cnt[..., None]
    return geometry.eigh3x3(cov)


def volume_whiten(rel, nbr_mask):
    """Offsets in the neighbourhood's principal frame, each axis divided by
    the square root of its eigenvalue (at least 1e-6)."""
    eigvals, eigvecs = _neighborhood_cov_eig(rel, nbr_mask)
    scale = 1.0 / torch.sqrt(torch.clamp(eigvals, min=1e-6))
    return torch.einsum("nkj,nji->nki", rel, eigvecs) * scale[:, None, :]


def plane_features(rel, nbr_mask):
    """The neighbourhood plane's normal (the smallest eigenvector) [N, 3]
    and each neighbour's signed distance to it [N, K, 1]."""
    _, eigvecs = _neighborhood_cov_eig(rel, nbr_mask)
    normal = eigvecs[..., 0]
    return normal, torch.einsum("nkj,nj->nk", rel, normal)[..., None]


class GraphEdgeConv(nn.Module):
    """One neighbourhood aggregation with the variant's edge message, then
    ``out_bn`` (``MaskedBatchNorm`` over the valid points) and ReLU."""

    def __init__(self, cin, out_channels, variant, generator=None):
        super().__init__()
        if variant not in VARIANTS:
            raise KeyError(variant)
        self.variant = variant
        extra = {"VolumeConvNet": 3, "PointPlaneNet": 4}.get(variant, 0)
        if variant in ("PointConvNet", "VolumeConvNet"):
            self.wnet0 = linear(3 + extra, 16, generator=generator)
            self.wnet1 = linear(16, out_channels, generator=generator)
            self.proj = linear(cin, out_channels, generator=generator)
        else:
            self.mlp0 = linear(3 + cin + extra, out_channels, generator=generator)
            self.bn0 = MaskedBatchNorm(out_channels)
            if variant == "PointGroupNet":
                self.center = linear(cin, out_channels, generator=generator)
                self.fuse = linear(2 * out_channels, out_channels, generator=generator)
        self.out_bn = MaskedBatchNorm(out_channels)

    def forward(self, feats, xyz, nbr_idx, nbr_mask, valid):
        n, k = nbr_idx.shape
        z = feats.new_zeros(())
        rel = torch.where(nbr_mask[..., None], _rows(xyz, nbr_idx) - xyz[:, None, :],
                          xyz.new_zeros(()))
        xj = torch.where(nbr_mask[..., None], _rows(feats, nbr_idx), z)
        extra = []
        if self.variant == "VolumeConvNet":
            extra.append(volume_whiten(rel, nbr_mask))
        elif self.variant == "PointPlaneNet":
            normal, dist = plane_features(rel, nbr_mask)
            extra += [normal[:, None, :].expand_as(rel), dist]
        if self.variant in ("PointConvNet", "VolumeConvNet"):
            wgt = self.wnet1(torch.relu(self.wnet0(torch.cat([rel] + extra, dim=-1))))
            msg = self.proj(xj) * torch.sigmoid(wgt)
            agg = torch.where(nbr_mask[..., None], msg, z).sum(1)
            agg = agg / torch.clamp(nbr_mask.sum(1), min=1)[:, None].to(agg.dtype)
        else:
            h = torch.cat([rel, xj] + extra, dim=-1).reshape(n * k, -1)
            h = torch.relu(self.bn0(self.mlp0(h), nbr_mask.reshape(-1))).reshape(n, k, -1)
            agg = torch.where(nbr_mask[..., None], h, torch.full_like(h, float("-inf"))).amax(1)
            agg = torch.where(nbr_mask.any(1)[:, None], agg, z)
            if self.variant == "PointGroupNet":
                agg = self.fuse(torch.cat([agg, self.center(feats)], dim=-1))
        return torch.relu(self.out_bn(agg, valid))


class GraphConvNet(nn.Module):
    """The shared encoder (level l: voxel means at ``base_cell`` * 2^l,
    ``conv<l>`` a ``GraphEdgeConv`` over the neighbours within 2.5 cells)
    and KPConvNet's decoder; PointNet2RepSurf first joins the points'
    ``UmbrellaSurfaceConstructor`` descriptors (``umbrella``) to their
    features. ``cin`` is the width of ``point_feat``."""

    def __init__(self, cin=1, variant="PointConvNet", channels=(64, 128, 256), base_cell=0.1,
                 nsample=16, out_channels=64, generator=None):
        from .repsurf import UmbrellaSurfaceConstructor

        super().__init__()
        if variant not in VARIANTS:
            raise KeyError(variant)
        self.variant, self.channels = variant, tuple(channels)
        self.base_cell, self.nsample = base_cell, nsample
        self.umbrella = None
        if variant == "PointNet2RepSurf":
            self.umbrella = UmbrellaSurfaceConstructor(generator=generator)
            cin += 10
        for li, ch in enumerate(self.channels):
            setattr(self, f"conv{li}", GraphEdgeConv(cin, ch, variant, generator=generator))
            cin = ch
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
        x = feats.to(dt)
        if self.umbrella is not None:
            x = torch.cat([x, self.umbrella(pts[:, 1:4].to(dt), bidx.long(), valid)], dim=-1)
        xyz, lvalid, levels = pts[:, 1:4], valid, []
        for li in range(len(self.channels)):
            cell = self.base_cell * (2 ** li)
            rep_xyz, rep_valid, inverse = _grid_reps(torch.cat([bidx[:, None], xyz], 1),
                                                     lvalid, cell)
            x = pool_to_reps(x, lvalid, inverse)
            xyz, lvalid = rep_xyz, rep_valid
            nbr, nmask = level_neighbours(bidx, xyz, lvalid, 2.5 * cell, self.nsample)
            x = getattr(self, f"conv{li}")(x, xyz.to(dt), nbr, nmask, lvalid)
            levels.append((xyz, lvalid, x))
        shift = torch.zeros_like(pts[:, 1:4])
        shift[:, 0] = 1e4 * bidx
        batch_dict["point_features"] = decode(self, levels, pts, valid, shift)
        batch_dict["point_coords"] = torch.cat([pts[:, 0:1], pts[:, 1:4]], dim=1)
        return batch_dict
