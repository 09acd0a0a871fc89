"""Graph blocks (counterpart of pcseqlearning_tpu.models.blocks): edge
convolution, message passing, graph attention, kernel-indexed message
passing and the grid convolution over it, KPConv; the conv-kernel
assigners and kernel positions. Each block is a function of the features
and padded neighbour or edge tables. Gathers that carry a gradient go
through ``segment_ops.take_rows`` (a reproducible backward on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import segment_ops
from .layers import MaskedBatchNorm, init_fan_in
from .vfe import linear


def _rows(x, idx):
    """x[idx] for an index tensor of any shape (clamped into range), with
    the reproducible backward."""
    idx = torch.clamp(idx, 0, x.shape[0] - 1)
    return segment_ops.take_rows(x, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])


def _kernel_stack(num, cin, cout, generator):
    """A [num, cin, cout] kernel stack drawn as flax's fan-in truncated
    normal (fan-in num * cin)."""
    w = nn.Parameter(torch.empty(num, cin, cout))
    init_fan_in(w, num * cin, generator)
    return w


class EdgeConvBlock(nn.Module):
    """DGCNN edge convolution: for each neighbour j of i the MLP of [x_i,
    x_j - x_i] (linear without bias, ``MaskedBatchNorm`` over the real
    edges of valid points, ReLU, per layer of ``mlp`` + (out_channels,)),
    then the max over the neighbours; 0 where a point has none or is not
    valid."""

    def __init__(self, cin, out_channels, mlp=(), generator=None):
        super().__init__()
        widths = tuple(mlp) + (out_channels,)
        c = 2 * cin
        for i, w in enumerate(widths):
            setattr(self, f"linear{i}", linear(c, w, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(w))
            c = w
        self.num_layers = len(widths)

    def forward(self, feats, nbr_idx, nbr_mask, valid):
        n, k = nbr_idx.shape
        xj = _rows(feats, nbr_idx)
        xi = feats[:, None, :].expand_as(xj)
        h = torch.cat([xi, xj - xi], dim=-1).reshape(n * k, -1)
        m = (nbr_mask & valid[:, None]).reshape(-1)
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(h), m))
        h = h.reshape(n, k, -1)
        out = torch.where(nbr_mask[..., None], h, torch.full_like(h, float("-inf"))).amax(1)
        has = nbr_mask.any(1) & valid
        return torch.where(has[:, None], out, out.new_zeros(()))


class MessagePassingBlock(nn.Module):
    """Message passing over a padded edge list: linear (no bias) of (source
    features, target features, source - target position),
    ``MaskedBatchNorm`` over the real edges, ReLU, then the mean ("mean"),
    sum or max at each target (0 where a target has no edge)."""

    def __init__(self, src_channels, dst_channels, out_channels, aggregate="mean",
                 generator=None):
        super().__init__()
        self.aggregate = aggregate
        self.linear0 = linear(src_channels + dst_channels + 3, out_channels, generator=generator)
        self.norm0 = MaskedBatchNorm(out_channels)

    def forward(self, src_feats, dst_feats, src_xyz, dst_xyz, e_src, e_dst, e_mask):
        nd = dst_feats.shape[0]
        es = torch.clamp(e_src, 0, src_feats.shape[0] - 1)
        ed = torch.clamp(e_dst, 0, nd - 1)
        rel = src_xyz[es] - dst_xyz[ed]
        msg = torch.cat([_rows(src_feats, es), _rows(dst_feats, ed), rel], dim=-1)
        msg = torch.relu(self.norm0(self.linear0(msg), e_mask))
        seg = torch.where(e_mask, ed, torch.full_like(ed, nd))
        if self.aggregate == "sum":
            return segment_ops.segment_sum(torch.where(e_mask[:, None], msg, msg.new_zeros(())),
                                           seg, nd + 1)[:nd]
        if self.aggregate == "max":
            return segment_ops.segment_max_or(
                torch.where(e_mask[:, None], msg, torch.full_like(msg, float("-inf"))), seg,
                nd + 1, 0.0)[:nd]
        return segment_ops.segment_mean(torch.where(e_mask[:, None], msg, msg.new_zeros(())),
                                        seg, nd + 1)[:nd]


class GraphAttentionBlock(nn.Module):
    """Edge-softmax attention: per head, the softmax over a point's
    neighbours of q . k / sqrt(d), weighting the neighbours' values (q, k
    and v linear with bias); 0 where a point has no neighbour or is not
    valid."""

    def __init__(self, cin, out_channels, num_heads=4, generator=None):
        super().__init__()
        self.out_channels, self.num_heads = out_channels, num_heads
        for i in range(3):  # q, k, v
            setattr(self, f"linear{i}", linear(cin, out_channels, bias=True, generator=generator))

    def forward(self, feats, nbr_idx, nbr_mask, valid):
        n, k = nbr_idx.shape
        h = self.num_heads
        d = self.out_channels // h
        q = self.linear0(feats).reshape(n, h, d)
        kv = _rows(feats, nbr_idx)
        kk = self.linear1(kv).reshape(n, k, h, d)
        vv = self.linear2(kv).reshape(n, k, h, d)
        logits = torch.einsum("nhd,nkhd->nkh", q, kk) / math.sqrt(d)
        logits = torch.where(nbr_mask[:, :, None], logits, torch.full_like(logits, float("-inf")))
        att = torch.softmax(logits, dim=1)
        att = torch.where(nbr_mask[:, :, None], att, att.new_zeros(()))
        out = torch.einsum("nkh,nkhd->nhd", att, vv).reshape(n, self.out_channels)
        keep = valid[:, None] & nbr_mask.any(1)[:, None]
        return torch.where(keep, out, out.new_zeros(()))


def compute_conv3d_positions(voxel_size):
    """The 27 conv-kernel offsets {-v, 0, v}^3 (x slowest), float32 [27, 3]."""
    vx, vy, vz = voxel_size
    pos = [[dx, dy, dz] for dx in (-vx, 0, vx) for dy in (-vy, 0, vy) for dz in (-vz, 0, vz)]
    return torch.tensor(np.asarray(pos, np.float32))


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in
    float64, the sum rounded there, then to float32)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def compute_ball_positions(num_kernel_points, radius=0.9):
    """``num_kernel_points`` kernel positions spread in a ball: farthest
    point sampling over the 24^3 grid of [-1, 1]^3 inside ``radius``
    (float32 [K, 3]). The symmetric grid ties many distances exactly, so
    the picks follow the JAX function's rounding on the CPU, where XLA
    fuses the squared distance into multiply-adds, fma(dz, dz, fma(dy, dy,
    dx * dx)); the first of equal maxima wins, as ``jnp.argmax``. A
    constant of the layer, computed in NumPy."""
    g = np.linspace(-1, 1, 24, dtype=np.float32)
    cand = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    cand = cand[np.linalg.norm(cand, axis=-1) <= radius]
    dist = np.full(len(cand), np.inf, np.float32)
    picks = [0]
    for _ in range(1, num_kernel_points):
        x = cand - cand[picks[-1]]
        d = _fma32(x[:, 2], x[:, 2], _fma32(x[:, 1], x[:, 1], x[:, 0] * x[:, 0]))
        dist = np.minimum(dist, d)
        picks.append(int(np.argmax(dist)))
    return torch.from_numpy(cand[picks])


def grid_assigner(rel_coords):
    """27-way index of the signs s of the relative voxel coords [E, 3]:
    k = 9 (s_z + 1) + 3 (s_y + 1) + (s_x + 1)."""
    k = torch.zeros(rel_coords.shape[0], dtype=torch.int64, device=rel_coords.device)
    for i in (2, 1, 0):
        k = k * 3 + (torch.sign(rel_coords[:, i]).to(torch.int64) + 1)
    return k


def grid3x3_assigner(rel_xyz, half_voxel_size):
    """``grid_assigner`` on relative positions [E, 3], a coordinate inside
    (-half, half) counting as 0."""
    hv = torch.as_tensor(half_voxel_size, dtype=torch.float32, device=rel_xyz.device)
    k = torch.zeros(rel_xyz.shape[0], dtype=torch.int64, device=rel_xyz.device)
    for i in (2, 1, 0):
        is_zero = (rel_xyz[:, i] < hv[i]) & (rel_xyz[:, i] > -hv[i])
        s = torch.where(is_zero, torch.zeros_like(rel_xyz[:, i]), torch.sign(rel_xyz[:, i]))
        k = k * 3 + (s.to(torch.int64) + 1)
    return k


def geometric_assigner(rel_xyz, kernel_pos):
    """Index of the nearest kernel position (the first of equals)."""
    kp = kernel_pos.to(rel_xyz.device)
    d2 = ((rel_xyz[:, None, :] - kp[None, :, :]) ** 2).sum(-1)
    return torch.argmin(d2, dim=1)


def grid_volume_assigner(rel_coords, query_volume_mask, e_query):
    """``grid_assigner`` doubled, plus the query's volume mask (54 kernels)."""
    vm = query_volume_mask[torch.clamp(e_query, 0, query_volume_mask.shape[0] - 1)]
    return 2 * grid_assigner(rel_coords) + vm.to(torch.int64)


ASSIGNERS = dict(GridAssigner=grid_assigner, Grid3x3Assigner=grid3x3_assigner,
                 GeometricAssigner=geometric_assigner, GridVolumeAssigner=grid_volume_assigner)


class KernelMessagePassing(nn.Module):
    """Each real edge applies one of ``num_kernels`` weight matrices to its
    (optionally weighted) source feature, summed at its query: the source
    features are first summed by (query, kernel), then contracted with the
    [K, Cin, Cout] stack (``kernel_weights``) in one einsum, as JAX does."""

    def __init__(self, cin, out_channels, num_kernels=27, generator=None):
        super().__init__()
        self.num_kernels = num_kernels
        self.kernel_weights = _kernel_stack(num_kernels, cin, out_channels, generator)

    def forward(self, ref_feats, e_kernel, e_ref, e_query, num_queries, e_mask, e_weight=None):
        K = self.num_kernels
        src = _rows(ref_feats, e_ref)
        if e_weight is not None:
            src = src * e_weight[:, None].to(src.dtype)
        src = torch.where(e_mask[:, None], src, src.new_zeros(()))
        key = torch.where(e_mask, torch.clamp(e_query, 0, num_queries - 1) * K
                          + torch.clamp(e_kernel, 0, K - 1),
                          torch.full_like(e_query, num_queries * K))
        pooled = segment_ops.segment_sum(src, key, num_queries * K + 1)[:num_queries * K]
        pooled = pooled.reshape(num_queries, K, -1)
        return torch.einsum("nkc,kco->no", pooled, self.kernel_weights)


class GridConvBlock(nn.Module):
    """``KernelMessagePassing`` (``kmp``), ``MaskedBatchNorm`` over the valid
    queries, ReLU; 0 for queries not valid."""

    def __init__(self, cin, out_channels, num_kernels=27, generator=None):
        super().__init__()
        self.kmp = KernelMessagePassing(cin, out_channels, num_kernels, generator=generator)
        self.norm0 = MaskedBatchNorm(out_channels)

    def forward(self, ref_feats, e_kernel, e_ref, e_query, num_queries, e_mask, q_valid,
                e_weight=None):
        out = self.kmp(ref_feats, e_kernel, e_ref, e_query, num_queries, e_mask, e_weight)
        out = torch.relu(self.norm0(out, q_valid))
        return torch.where(q_valid[:, None], out, out.new_zeros(()))


def kernel_points(num_kernel_points, sigma):
    """KPConv's kernel points: the centre, then a Fibonacci sphere of
    radius ``sigma`` (float32 [K, 3], as the JAX block builds them)."""
    k = num_kernel_points
    pts = [np.zeros(3)]
    golden = np.pi * (3 - np.sqrt(5))
    for i in range(k - 1):
        y = 1 - (i / max(k - 2, 1)) * 2
        r = np.sqrt(max(1 - y * y, 0))
        th = golden * i
        pts.append(np.array([np.cos(th) * r, y, np.sin(th) * r]) * sigma)
    return torch.tensor(np.stack(pts), dtype=torch.float32)


class KPConvBlock(nn.Module):
    """Kernel point convolution: each neighbour's features weighted by its
    linear influence max(0, 1 - |rel - kernel point| / sigma) on each kernel
    point, summed over the neighbours, contracted with the [P, Cin, Cout]
    ``kp_weights``; then ``MaskedBatchNorm`` (``norm0``) and ReLU; 0 for
    points not valid."""

    def __init__(self, cin, out_channels, num_kernel_points=15, sigma=0.5, generator=None):
        super().__init__()
        self.sigma = float(sigma)
        self.register_buffer("kernel_pts", kernel_points(num_kernel_points, self.sigma),
                             persistent=False)
        self.kp_weights = _kernel_stack(num_kernel_points, cin, out_channels, generator)
        self.norm0 = MaskedBatchNorm(out_channels)

    def forward(self, feats, xyz, nbr_idx, nbr_mask, valid):
        rel = _rows(xyz, nbr_idx) - xyz[:, None, :]
        kp = self.kernel_pts.to(rel.dtype)
        d = torch.linalg.norm(rel[:, :, None, :] - kp[None, None, :, :], dim=-1)
        infl = torch.clamp(1.0 - d / self.sigma, min=0.0)
        infl = torch.where(nbr_mask[:, :, None], infl, infl.new_zeros(())).to(feats.dtype)
        per_p = torch.einsum("nkp,nkc->npc", infl, _rows(feats, nbr_idx))
        out = torch.einsum("npc,pco->no", per_p, self.kp_weights)
        out = torch.relu(self.norm0(out, valid))
        return torch.where(valid[:, None], out, out.new_zeros(()))
