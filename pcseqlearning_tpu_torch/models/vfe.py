"""Voxel feature encoders (counterpart of pcseqlearning_tpu.models.vfe):
``DynamicMeanVFE`` (CenterPoint, SECOND, Voxel R-CNN), ``DynPillarVFE``
(PointPillar, SST-CenterPoint) and ``ImageVFE`` (CaDDN's camera front end,
with LID depth binning, the lidar depth map and the frustum sampler). The
other encoders wait for the model zoo that uses them (ROADMAP.md, queue 1
item 4.6)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import grid_utils, segment_ops
from ..ops.roi_pool import _true_div
from .backbones_2d import conv2d
from .layers import BatchNorm2d, MaskedBatchNorm, init_fan_in


class DynamicMeanVFE(nn.Module):
    """Mean of (x, y, z, point features) per voxel over the points inside
    the range, with no cap on the points per voxel. Points outside the
    range or not valid are moved to 1e8 (their own voxel, last in order),
    as in the JAX module."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = int(voxel_cap)

    def forward(self, batch_dict):
        points = batch_dict["point_bxyz"]
        feats = batch_dict["point_feat"]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
        pcr = torch.tensor(self.point_cloud_range, dtype=points.dtype, device=points.device)
        inside = ((points[:, 1:4] >= pcr[:3]) & (points[:, 1:4] < pcr[3:])).all(dim=-1)
        valid = valid & inside
        pts = torch.where(valid[:, None], points, torch.full_like(points, 1e8))
        full = torch.cat([points[:, 1:4], feats], dim=-1)
        coords, vfeat, vvalid, inverse = grid_utils.dynamic_voxelize(
            pts, full, self.voxel_size, pcr[:3], self.voxel_cap)
        batch_dict["voxel_features"] = torch.where(vvalid[:, None], vfeat,
                                                   torch.zeros_like(vfeat))
        batch_dict["voxel_coords"] = torch.where(vvalid[:, None], coords,
                                                 torch.full_like(coords, -1))
        batch_dict["voxel_valid"] = vvalid
        batch_dict["point_voxel_inverse"] = inverse
        return batch_dict


def linear(cin, cout, bias=False, generator=None):
    """nn.Linear initialised as flax's nn.Dense (lecun_normal, zero bias)."""
    lin = nn.Linear(cin, cout, bias=bias)
    init_fan_in(lin.weight, cin, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class DynPillarVFE(nn.Module):
    """Dynamic pillar encoder: each point's (x, y, z), features, offset from
    its pillar's point mean and offset from its pillar's centre go through
    the PFN (linear, ``MaskedBatchNorm``, ReLU per filter), then a max over
    the pillar's points. Pillars are the distinct (b, x cell, y cell) of the
    valid points inside the range, in lexicographic order, at most
    ``pillar_cap``; their coords are (b, 0, y, x). The max splits a tie's
    gradient evenly among the tied points, as JAX's ``segment_max``
    does."""

    def __init__(self, voxel_size, point_cloud_range, pillar_cap, num_filters=(64,),
                 num_point_features=4, generator=None):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = self.pillar_cap = int(pillar_cap)
        cin = num_point_features + 3 + 2  # x, y, z, features, cluster and pillar offsets
        for i, nf in enumerate(num_filters):
            setattr(self, f"linear{i}", linear(cin, nf, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(nf))
            cin = nf
        self.num_layers, self.out_channels = len(num_filters), cin

    def forward(self, batch_dict):
        points, feats = batch_dict["point_bxyz"], batch_dict["point_feat"]
        dev, n = points.device, points.shape[0]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        pcr = torch.tensor(self.point_cloud_range, dtype=points.dtype, device=dev)
        vs = torch.tensor(self.voxel_size, dtype=points.dtype, device=dev)
        xyz = points[:, 1:4]
        valid = valid & ((xyz >= pcr[:3]) & (xyz < pcr[3:])).all(dim=-1)
        b = torch.round(points[:, 0]).to(torch.int32)
        cxy = torch.floor((points[:, 1:3] - pcr[:2]) / vs[:2]).to(torch.int32)
        coords = torch.where(valid[:, None], torch.cat([b[:, None], cxy], 1),
                             torch.full((n, 3), 2 ** 24, dtype=torch.int32, device=dev))
        inverse, _, _ = grid_utils.unique_rows(coords)
        cap = self.pillar_cap
        inv_safe = torch.where(valid, inverse, torch.full_like(inverse, cap))

        mean_xyz = segment_ops.segment_mean(xyz, inv_safe, cap + 1)[:cap]
        f_cluster = xyz - mean_xyz[torch.clamp(inverse, 0, cap - 1)]
        f_center = points[:, 1:3] - ((cxy.to(points.dtype) + 0.5) * vs[:2] + pcr[:2])
        # the cells in the points' dtype, the PFN in the module's
        x = torch.cat([xyz, feats, f_cluster, f_center], dim=-1).to(self.linear0.weight.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid)
            x = torch.relu(x)
        x = torch.where(valid[:, None], x, torch.full_like(x, float("-inf")))
        pooled = segment_ops.segment_max_or(x, inv_safe, cap + 1, 0.0)[:cap]
        pvalid = segment_ops.segment_count(inv_safe, cap + 1)[:cap] > 0.5
        pc = segment_ops.segment_min_or(coords, inv_safe, cap + 1, 0)[:cap]
        vc = torch.stack([pc[:, 0], torch.zeros_like(pc[:, 0]), pc[:, 2], pc[:, 1]], dim=1)
        batch_dict["pillar_features"] = torch.where(pvalid[:, None], pooled,
                                                    torch.zeros_like(pooled))
        batch_dict["voxel_features"] = batch_dict["pillar_features"]
        batch_dict["voxel_coords"] = torch.where(pvalid[:, None], vc, torch.full_like(vc, -1))
        batch_dict["voxel_valid"] = pvalid
        return batch_dict


def bin_depths_lid(depth, depth_min, depth_max, num_bins, target=False):
    """LID (linear-increasing) depth bins (CaDDN): the continuous bin
    coordinate -0.5 + 0.5 * sqrt(1 + 8 (depth - min) / bin_size), bin_size
    = 2 (max - min) / (D (1 + D)); with ``target``, its floor as int32, and
    bin D (overflow) where it is below 0, above D or not finite. The
    division is by a tensor, so the card rounds as the CPU does (the floor
    decides the bin)."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = -0.5 + 0.5 * torch.sqrt(1 + _true_div(8 * (depth - depth_min), bin_size))
    if target:
        bad = (idx < 0) | (idx > num_bins) | ~torch.isfinite(idx)
        return torch.where(bad, torch.full_like(idx, num_bins), torch.floor(idx)).to(torch.int32)
    return idx


def _transform(xyz, m):
    """xyz [N, 3] through the affine rows of m [>=3, 4] (x m[:3, :3]^T +
    m[:3, 3]), each coordinate summed in the order x, y, z, translation."""
    return torch.stack([xyz[:, 0] * m[i, 0] + xyz[:, 1] * m[i, 1] + xyz[:, 2] * m[i, 2] + m[i, 3]
                        for i in range(3)], dim=-1)


def _project(xyz, K):
    """xyz [N, 3] times K^T [3, 3], summed in the order x, y, z."""
    return torch.stack([xyz[:, 0] * K[i, 0] + xyz[:, 1] * K[i, 1] + xyz[:, 2] * K[i, 2]
                        for i in range(3)], dim=-1)


def lidar_depth_map(points, valid, K, T, H, W):
    """[H, W] camera depth of the nearest valid lidar point on each pixel
    (0 where none lands): the points through T (lidar to camera) and K,
    pixels rounded half to even; a scatter-min, which no order changes.
    points [N, 3]; K [3, 3]; T [4, 4]."""
    cam = _transform(points, T.to(points.dtype))
    depth = cam[:, 2]
    uvw = _project(cam, K.to(points.dtype))
    den = torch.clamp(depth, min=1e-3)
    u = torch.round(uvw[:, 0] / den).long()
    v = torch.round(uvw[:, 1] / den).long()
    ok = valid & (depth > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    flat = torch.where(ok, v * W + u, torch.full_like(u, H * W))
    big = torch.tensor(1e9, dtype=points.dtype, device=points.device)
    dmap = torch.full((H * W + 1,), 1e9, dtype=points.dtype, device=points.device)
    dmap = dmap.scatter_reduce(0, flat, torch.where(ok, depth, big), "amin")[:H * W]
    return torch.where(dmap >= big, dmap.new_zeros(()), dmap).reshape(H, W)


def frustum_sample_voxels(feat, prob, K, T, centers, img_hw, min_depth, max_depth, depth_bins):
    """Trilinear samples of the frustum volume prob x feat at voxel centres,
    without the [h, w, D, C] volume: per image-plane corner, the corner's
    features times its depth probability interpolated between two LID bins
    (zero past either end of [0, D - 1]), times the corner's weight; zeros
    outside the frustum.

    feat [h, w, C]; prob [h, w, D]; K [3, 3]; T [4, 4] lidar to camera;
    centers [V, 3] in the lidar frame; img_hw the full image's (H, W).
    Returns [V, C]. The gathers carry the gradient reproducibly."""
    H, W = img_hw
    h, w, c = feat.shape
    cam = _transform(centers, T.to(centers.dtype))
    depth = torch.clamp(cam[:, 2], min=1e-3)
    uvw = _project(cam, K.to(centers.dtype))
    u = uvw[:, 0] / depth * (w / W)
    v = uvw[:, 1] / depth * (h / H)
    d = bin_depths_lid(cam[:, 2], min_depth, max_depth, depth_bins)
    inside = ((u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1) & (cam[:, 2] > 0) & (d > -1.0)
              & (d < depth_bins))
    u0 = torch.clamp(torch.floor(u).long(), 0, w - 2)
    v0 = torch.clamp(torch.floor(v).long(), 0, h - 2)
    wu = torch.clamp(u - u0, 0, 1)[:, None]
    wv = torch.clamp(v - v0, 0, 1)[:, None]
    # a NaN bin (a voxel nearer than the first bin) converts to 0, as XLA
    # converts a float to an int (saturating, NaN to 0)
    d0 = torch.clamp(torch.floor(d).nan_to_num(0.0), -2 ** 31, 2 ** 31 - 1).long()
    wd1 = torch.clamp(d - d0, 0, 1)
    ok0 = (d0 >= 0) & (d0 < depth_bins)
    ok1 = (d0 + 1 >= 0) & (d0 + 1 < depth_bins)
    d0c = torch.clamp(d0, 0, depth_bins - 1)
    d1c = torch.clamp(d0 + 1, 0, depth_bins - 1)
    feat_rows = feat.reshape(h * w, c)
    prob_rows = prob.reshape(h * w * depth_bins, 1)
    zero = feat.new_zeros(())

    def corner(vi, ui, wgt):
        pix = vi * w + ui
        p0 = segment_ops.take_rows(prob_rows, pix * depth_bins + d0c)[:, 0]
        p1 = segment_ops.take_rows(prob_rows, pix * depth_bins + d1c)[:, 0]
        pd = torch.where(ok0, p0, zero) * (1 - wd1) + torch.where(ok1, p1, zero) * wd1
        return segment_ops.take_rows(feat_rows, pix) * pd[:, None] * wgt

    f = (corner(v0, u0, (1 - wu) * (1 - wv)) + corner(v0, u0 + 1, wu * (1 - wv))
         + corner(v0 + 1, u0, (1 - wu) * wv) + corner(v0 + 1, u0 + 1, wu * wv))
    return torch.where(inside[:, None], f, zero)


def _eye(n, b, like):
    return torch.eye(n, dtype=torch.float32, device=like.device).expand(b, n, n)


class ImageVFE(nn.Module):
    """CaDDN's camera front end: an image encoder (two stride-2 3x3 convs
    without bias, each with ``BatchNorm2d`` and ReLU, then 1x1 convs with
    bias to ``channels`` features (``feat``) and depth_bins + 1 depth logits
    (``depth``), the last the beyond-range class, dropped after the softmax
    without renormalising); then the dense voxel grid (z, y, x row-major,
    sample after sample) sampled through the frustum.

    Only the rows the voxel table keeps are sampled: the first
    ``voxel_cap`` of the B x nz x ny x nx grid (with a cap below one
    sample's grid, sample 0's lowest z-slabs), rows past the grid padded
    (coords -1, not valid). The JAX module samples every voxel and then
    keeps the same rows; each row is computed alone, so the values and
    gradients are the same. ``depth_loss`` is the DDN focal loss.

    Writes depth_logits [B, h, w, D + 1] (channels last, as in JAX),
    image_downsample, and the voxel table (voxel_features [cap, C],
    voxel_coords (b, z, y, x) int32, voxel_valid)."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap, depth_bins=16, min_depth=2.0,
                 max_depth=60.0, channels=32, focal_alpha=0.25, focal_gamma=2.0, fg_weight=13.0,
                 bg_weight=1.0, loss_weight=3.0, generator=None):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_cap = int(voxel_cap)
        self.depth_bins, self.min_depth, self.max_depth = depth_bins, min_depth, max_depth
        self.focal_alpha, self.focal_gamma = focal_alpha, focal_gamma
        self.fg_weight, self.bg_weight, self.loss_weight = fg_weight, bg_weight, loss_weight
        self.out_channels = channels
        self.enc0 = conv2d(3, channels, 3, stride=2, padding=1, generator=generator)
        self.enc_bn0 = BatchNorm2d(channels)
        self.enc1 = conv2d(channels, channels, 3, stride=2, padding=1, generator=generator)
        self.enc_bn1 = BatchNorm2d(channels)
        self.feat = conv2d(channels, channels, 1, bias=True, generator=generator)
        self.depth = conv2d(channels, depth_bins + 1, 1, bias=True, generator=generator)
        pcr, vs = self.point_cloud_range, self.voxel_size
        self.grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))

    def kept_rows(self, batch_size, device):
        """(coords [rows, 4] (b, z, y, x) int64 of the table's first rows,
        centres [rows, 3] float32), rows = min(cap, B x grid)."""
        nx, ny, nz = self.grid
        r = torch.arange(min(self.voxel_cap, batch_size * nx * ny * nz), device=device)
        b, g = r // (nx * ny * nz), r % (nx * ny * nz)
        iz, iy, ix = g // (nx * ny), (g // nx) % ny, g % nx
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=device)
        lo = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=device)
        centers = torch.stack([(i.to(torch.float32) + 0.5) * vs[k] + lo[k]
                               for k, i in enumerate((ix, iy, iz))], dim=-1)
        return torch.stack([b, iz, iy, ix], dim=1), centers

    def forward(self, batch_dict):
        img = batch_dict["images"]  # [B, H, W, 3]
        B, H, W, _ = img.shape
        x = img.permute(0, 3, 1, 2).to(self.enc0.weight.dtype)
        x = torch.relu(self.enc_bn0(self.enc0(x)))
        x = torch.relu(self.enc_bn1(self.enc1(x)))
        feat = self.feat(x).permute(0, 2, 3, 1)  # [B, h, w, C]
        depth_logits = self.depth(x).permute(0, 2, 3, 1)
        prob = torch.softmax(depth_logits, dim=-1)[..., :self.depth_bins]
        h, w = feat.shape[1], feat.shape[2]
        batch_dict["depth_logits"] = depth_logits
        batch_dict["image_downsample"] = H // h
        K = batch_dict.get("calib_K")
        T = batch_dict.get("calib_T")
        K = _eye(3, B, img) if K is None else K
        T = _eye(4, B, img) if T is None else T
        coords, centers = self.kept_rows(B, img.device)
        centers = centers.to(feat.dtype)
        vox = [frustum_sample_voxels(feat[b], prob[b], K[b], T[b], centers[coords[:, 0] == b],
                                     (H, W), self.min_depth, self.max_depth, self.depth_bins)
               for b in range(B) if bool((coords[:, 0] == b).any())]
        vox = torch.cat(vox)
        rows, cap = vox.shape[0], self.voxel_cap
        valid = torch.ones(rows, dtype=torch.bool, device=img.device)
        coords = coords.to(torch.int32)
        if rows < cap:
            vox = torch.cat([vox, vox.new_zeros((cap - rows, vox.shape[1]))])
            coords = torch.cat([coords, coords.new_full((cap - rows, 4), -1)])
            valid = torch.cat([valid, valid.new_zeros(cap - rows)])
        batch_dict.update(voxel_features=vox, voxel_coords=coords, voxel_valid=valid)
        return batch_dict

    def depth_loss(self, batch_dict):
        """The DDN depth loss: focal cross-entropy (alpha, gamma) of the depth
        logits against the LID bin of each pixel's depth (``depth_maps``
        [B, H, W], or built from the lidar points by ``lidar_depth_map``;
        min-pooled over positive depths to the logits' resolution; pixels
        with no return take the overflow bin), each pixel weighted
        ``fg_weight`` inside a ``gt_boxes2d`` box [B, N, 4] (u1, v1, u2, v2
        at full resolution; a box with u2 <= u1 or v2 <= v1 is empty) and
        ``bg_weight`` elsewhere; the mean over pixels times
        ``loss_weight``."""
        logits = batch_dict["depth_logits"]
        B, h, w, _ = logits.shape
        dev, dt = logits.device, logits.dtype
        dmaps = batch_dict.get("depth_maps")
        if dmaps is None:
            pts = batch_dict["point_bxyz"]
            val = batch_dict.get("point_valid")
            if val is None:
                val = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
            ds0 = int(batch_dict.get("image_downsample", 4))
            K = batch_dict.get("calib_K")
            T = batch_dict.get("calib_T")
            K = _eye(3, B, pts) if K is None else K
            T = _eye(4, B, pts) if T is None else T
            bidx = torch.round(pts[:, 0]).long()
            dmaps = torch.stack([lidar_depth_map(pts[:, 1:4], val & (bidx == b), K[b], T[b],
                                                 h * ds0, w * ds0) for b in range(B)])
        ds = dmaps.shape[1] // h
        if ds > 1:  # nearest surface: a min-pool of the positive depths
            dm = dmaps[:, :h * ds, :w * ds].reshape(B, h, ds, w, ds)
            big = torch.tensor(1e9, dtype=dm.dtype, device=dev)
            pooled = torch.where(dm > 0, dm, big).amin(dim=(2, 4))
            dmaps = torch.where(pooled >= big, pooled.new_zeros(()), pooled)
        target = bin_depths_lid(torch.where(dmaps > 0, dmaps, torch.full_like(dmaps, -1.0)),
                                self.min_depth, self.max_depth, self.depth_bins, target=True)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
        pt = torch.exp(-ce)
        focal = self.focal_alpha * (1.0 - pt) ** self.focal_gamma * ce
        weights = torch.full((B, h, w), self.bg_weight, dtype=dt, device=dev)
        boxes2d = batch_dict.get("gt_boxes2d")
        if boxes2d is not None:
            uu = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
            vv = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
            bb = _true_div(boxes2d, float(batch_dict.get("image_downsample", 4)))
            fg = torch.zeros((B, h, w), dtype=torch.bool, device=dev)
            for i in range(boxes2d.shape[1]):
                u1, v1, u2, v2 = (bb[:, i, j][:, None, None] for j in range(4))
                fg |= (u2 > u1) & (v2 > v1) & (uu >= u1) & (uu <= u2) & (vv >= v1) & (vv <= v2)
            weights = torch.where(fg, torch.full_like(weights, self.fg_weight),
                                  torch.full_like(weights, self.bg_weight))
        return (focal * weights).sum() / (B * h * w) * self.loss_weight
