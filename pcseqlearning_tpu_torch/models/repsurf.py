"""RepSurf umbrella surface representation (counterpart of
pcseqlearning_tpu.models.repsurf): each point's fan of triangles (point,
n_i, n_i+1) over its k nearest neighbours sorted by azimuth, a 10-channel
descriptor per triangle (centroid, its spherical coordinates, the +z
unit normal, the plane constant), a learnable two-layer map and a sum
over the fan."""

from __future__ import annotations

import torch
from torch import nn

from .layers import MaskedBatchNorm
from .vfe import _oriented_normal, _umbrella, linear


def umbrella_triangles(xyz, batch_idx, valid, k=9):
    """Per-point umbrella triangle geometry: (normal [N, k, 3] +z-oriented
    unit normals, centroid [N, k, 3], polar [N, k, 3] the centroid's
    spherical coordinates, pos [N, k, 1] = <normal, centroid>, pair_ok
    [N, k]); zero where a triangle's two neighbours are not both there."""
    from ..utils.polar_utils import cartesian_to_spherical

    v0, v1, pair_ok = _umbrella(xyz, batch_idx, valid, k)
    unit, _ = _oriented_normal(v0, v1)
    centroid = (v0 + v1) / 3.0
    polar = cartesian_to_spherical(centroid)
    pos = (unit * centroid).sum(-1, keepdim=True)
    w, z = pair_ok[..., None], xyz.new_zeros(())
    return (torch.where(w, unit, z), torch.where(w, centroid, z), torch.where(w, polar, z),
            torch.where(w, pos, z), pair_ok)


class UmbrellaSurfaceConstructor(nn.Module):
    """Learnable umbrella descriptor: each triangle's 10 channels (centroid,
    polar, normal, pos) through ``mlp0`` (linear with bias), ``bn0``
    (``MaskedBatchNorm`` over the triangles that are there), ReLU and
    ``mlp1``, summed over the fan; zero for points not valid."""

    def __init__(self, channels=10, k=9, generator=None):
        super().__init__()
        self.k = int(k)
        self.mlp0 = linear(10, channels, bias=True, generator=generator)
        self.bn0 = MaskedBatchNorm(channels)
        self.mlp1 = linear(channels, channels, bias=True, generator=generator)

    def forward(self, xyz, batch_idx, valid):
        normal, centroid, polar, pos, pair_ok = umbrella_triangles(xyz, batch_idx, valid, self.k)
        feat = torch.cat([centroid, polar, normal, pos], dim=-1)
        n, k, c = feat.shape
        h = torch.relu(self.bn0(self.mlp0(feat.reshape(n * k, c)), pair_ok.reshape(-1)))
        h = self.mlp1(h).reshape(n, k, -1)
        out = torch.where(pair_ok[..., None], h, h.new_zeros(())).sum(1)
        return torch.where(valid[:, None], out, out.new_zeros(()))
