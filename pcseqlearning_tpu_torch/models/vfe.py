"""Voxel feature encoders (counterpart of pcseqlearning_tpu.models.vfe):
``DynamicMeanVFE`` (CenterPoint, SECOND, Voxel R-CNN), ``DynPillarVFE``
(PointPillar, SST-CenterPoint), ``ImageVFE`` (CaDDN's camera front end,
with LID depth binning, the lidar depth map and the frustum sampler) and
the model zoo's encoders that no config names: ``DynamicVFE``,
``PlaneFittingVFE`` (also HybridVFE), ``RepsurfDynamicVFE`` with the
umbrella surface features, and ``TemporalVFE``."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import grid_utils, segment_ops
from ..ops.geometry import sqrt_rn
from ..ops.roi_pool import _true_div
from ..utils import profiler, telemetry
from .backbones_2d import conv2d
from .layers import BatchNorm2d, MaskedBatchNorm, init_fan_in


class DynamicMeanVFE(nn.Module):
    """Mean of (x, y, z, point features) per voxel over the points inside
    the range, with no cap on the points per voxel. Points outside the
    range or not valid are moved to 1e8 (their own voxel, last in order),
    as in the JAX module. While ``utils.profiler`` traces, the counters
    ``vfe.points`` (valid points inside the range) and ``vfe.points_dropped``
    (those of them whose voxel the cap drops) count on the device."""

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
        if profiler.enabled():
            telemetry.add("vfe.points", valid.sum())
            telemetry.add("vfe.points_dropped", (valid & (inverse >= self.voxel_cap)).sum())
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
    division is by a tensor and the square root rounded to nearest, so the
    card rounds as the CPU does and as NumPy does (the floor decides the
    bin)."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = -0.5 + 0.5 * sqrt_rn(1 + _true_div(8 * (depth - depth_min), bin_size))
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


def _cells(vfe, batch_dict):
    """The dynamic VFEs' shared start: points, features, validity (inside
    the range), and the voxels of the table with invalid points at 1e8:
    (points, feats, valid, coords, vvalid, inverse, inv_safe), inv_safe
    routing invalid points to the sink segment ``voxel_cap``."""
    points, feats = batch_dict["point_bxyz"], batch_dict["point_feat"]
    valid = batch_dict.get("point_valid")
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    pcr = torch.tensor(vfe.point_cloud_range, dtype=points.dtype, device=points.device)
    valid = valid & ((points[:, 1:4] >= pcr[:3]) & (points[:, 1:4] < pcr[3:])).all(dim=-1)
    pts = torch.where(valid[:, None], points, torch.full_like(points, 1e8))
    coords, _, vvalid, inverse = grid_utils.dynamic_voxelize(pts, feats, vfe.voxel_size, pcr[:3],
                                                             vfe.voxel_cap)
    inv_safe = torch.where(valid, inverse, torch.full_like(inverse, vfe.voxel_cap))
    return points, feats, valid, coords, vvalid, inverse, inv_safe


def _to_voxel(vfe, points, inverse, inv_safe):
    """Each point's xyz, offset from its voxel's point mean."""
    cap = vfe.voxel_cap
    mean_xyz = segment_ops.segment_mean(points[:, 1:4], inv_safe, cap + 1)[:cap]
    return points[:, 1:4] - mean_xyz[torch.clamp(inverse, 0, cap - 1)]


def _write_voxels(batch_dict, vfeat, coords, vvalid):
    batch_dict["voxel_features"] = torch.where(vvalid[:, None], vfeat, vfeat.new_zeros(()))
    batch_dict["voxel_coords"] = torch.where(vvalid[:, None], coords, torch.full_like(coords, -1))
    batch_dict["voxel_valid"] = vvalid
    return batch_dict


class DynamicVFE(nn.Module):
    """Dynamic voxel encoder with a point-voxel ladder: each point's (x, y,
    z), features and offset from its voxel's point mean go through
    ``num_filters`` layers (linear, ``MaskedBatchNorm``, ReLU), each followed
    by the voxel max of its output, which joins the next layer's input. The
    last max is the voxel feature. ``num_point_features`` counts x, y, z and
    the point features."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap, num_filters=(64, 128),
                 num_point_features=4, generator=None):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = int(voxel_cap)
        cin = num_point_features + 3
        for i, nf in enumerate(num_filters):
            setattr(self, f"linear{i}", linear(cin, nf, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(nf))
            cin = 2 * nf
        self.num_layers, self.out_channels = len(num_filters), int(num_filters[-1])

    def forward(self, batch_dict):
        points, feats, valid, coords, vvalid, inverse, inv_safe = _cells(self, batch_dict)
        cap, rows = self.voxel_cap, torch.clamp(inverse, 0, self.voxel_cap - 1)
        x = torch.cat([points[:, 1:4], feats, _to_voxel(self, points, inverse, inv_safe)], dim=-1)
        x = x.to(self.linear0.weight.dtype)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
            vmax = segment_ops.segment_max_or(
                torch.where(valid[:, None], x, torch.full_like(x, float("-inf"))), inv_safe,
                cap + 1, 0.0)[:cap]
            if i + 1 < self.num_layers:
                x = torch.cat([x, segment_ops.take_rows(vmax, rows)], dim=-1)
        batch_dict = _write_voxels(batch_dict, vmax, coords, vvalid)
        batch_dict["point_voxel_inverse"] = inverse
        return batch_dict


class PlaneFittingVFE(nn.Module):
    """Plane-fit voxel features (no parameters): each voxel's mean of (x, y,
    z, point features), then the normal, eigenvalues and weight sum of
    ``primitive_fitting`` over the valid points, as JAX computes them. As
    in JAX, the points are not clipped to the range, and the fit numbers
    its voxels from the table's own minimum corner, so its row v is the
    v-th occupied cell of that grid, not necessarily voxel v of the
    table."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap, num_point_features=4):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap = int(voxel_cap)
        self.out_channels = num_point_features + 7

    def forward(self, batch_dict):
        from ..ops.primitives import primitive_fitting

        points, feats = batch_dict["point_bxyz"], batch_dict["point_feat"]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
        pcr = torch.tensor(self.point_cloud_range, dtype=points.dtype, device=points.device)
        pts = torch.where(valid[:, None], points, torch.full_like(points, 1e8))
        coords, vfeat, vvalid, _ = grid_utils.dynamic_voxelize(
            pts, torch.cat([points[:, 1:4], feats], dim=-1), self.voxel_size, pcr[:3],
            self.voxel_cap)
        fit = primitive_fitting(pts, valid, self.voxel_size, self.voxel_cap)
        geo = torch.cat([fit["normals"], fit["eigvals"], fit["weight_sum"][:, None]], dim=-1)
        batch_dict = _write_voxels(batch_dict, torch.cat([vfeat, geo], dim=-1), coords, vvalid)
        batch_dict["voxel_normals"] = fit["normals"]
        batch_dict["voxel_eigvals"] = fit["eigvals"]
        return batch_dict


def _umbrella(xyz, batch_idx, valid, k):
    """Each point's k nearest neighbours of its own sample (valid ones),
    sorted by azimuth around it: (rel [N, k, 3] offsets, 0 where missing;
    ok [N, k]), and the fan's consecutive pairs (v0, v1, pair_ok)."""
    from ..ops import sampling

    n = xyz.shape[0]
    idx, nd2 = sampling.knn_bruteforce(xyz, xyz, k + 1, ref_valid=valid, ref_batch=batch_idx,
                                       query_batch=batch_idx)
    idx, nd2 = idx[:, 1:], nd2[:, 1:]  # drop self
    nbr_ok = torch.isfinite(nd2) & valid[:, None]
    rel = xyz[torch.clamp(idx, 0, n - 1)] - xyz[:, None, :]
    rel = torch.where(nbr_ok[..., None], rel, rel.new_zeros(()))
    az = torch.where(nbr_ok, torch.atan2(rel[..., 1], rel[..., 0]),
                     torch.full_like(rel[..., 0], 1e9))  # missing neighbours sort last
    order = torch.sort(az, dim=1, stable=True).indices
    rel = torch.gather(rel, 1, order[..., None].expand(-1, -1, 3))
    ok = torch.gather(nbr_ok, 1, order)
    v1 = torch.roll(rel, -1, dims=1)
    return rel, v1, ok & torch.roll(ok, -1, dims=1)


def _oriented_normal(v0, v1):
    """Unit normals of the triangles (0, v0, v1), turned to +z, and the
    cross products' norms."""
    nrm = torch.linalg.cross(v0, v1, dim=-1)
    norm = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    unit = nrm / torch.clamp(norm, min=1e-9)
    return unit * torch.where(unit[..., 2:3] < 0, -1.0, 1.0).to(unit.dtype), norm[..., 0]


def umbrella_surface_features(xyz, batch_idx, valid, k=9):
    """Per-point umbrella surface features [N, 10] (no parameters): over
    the fan of triangles (point, n_i, n_i+1) of its k nearest neighbours
    sorted by azimuth, the mean unit normal (turned to +z), the mean
    centroid offset, that offset's spherical coordinates and the mean
    area; zero for points not valid."""
    from ..utils.polar_utils import cartesian_to_spherical

    v0, v1, pair_ok = _umbrella(xyz, batch_idx, valid, k)
    unit, norm = _oriented_normal(v0, v1)
    area = 0.5 * norm
    centroid = (v0 + v1) / 3.0
    w = pair_ok.to(xyz.dtype)[..., None]
    cnt = torch.clamp(w.sum(1), min=1e-6)
    mean_n = (unit * w).sum(1) / cnt
    mean_c = (centroid * w).sum(1) / cnt
    mean_a = (area[..., None] * w).sum(1) / cnt
    feats = torch.cat([mean_n, mean_c, cartesian_to_spherical(mean_c), mean_a], dim=-1)
    return torch.where(valid[:, None], feats, feats.new_zeros(()))


class RepsurfDynamicVFE(nn.Module):
    """Dynamic voxel encoder with umbrella surface features: each point's
    (x, y, z), features and voxel offset go through ``mlp_channels`` layers
    (linear, ``MaskedBatchNorm``, ReLU), each followed by the voxel mean of
    its output (joined to the next layer's input); the last mean is
    concatenated with the voxel mean of the points' learnable umbrella
    descriptors (``UmbrellaSurfaceConstructor``, under ``umbrella``; 10
    channels), or of ``umbrella_surface_features`` without
    ``learnable_surface``."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap, mlp_channels=(32, 64), knn=9,
                 learnable_surface=True, num_point_features=4, generator=None):
        from .repsurf import UmbrellaSurfaceConstructor

        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap, self.knn = int(voxel_cap), int(knn)
        cin = num_point_features + 3
        for i, nf in enumerate(mlp_channels):
            setattr(self, f"linear{i}", linear(cin, nf, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(nf))
            cin = 2 * nf
        self.num_layers = len(mlp_channels)
        self.umbrella = (UmbrellaSurfaceConstructor(k=self.knn, generator=generator)
                         if learnable_surface else None)
        self.out_channels = int(mlp_channels[-1]) + 10

    def forward(self, batch_dict):
        points, feats, valid, coords, vvalid, inverse, inv_safe = _cells(self, batch_dict)
        cap, rows = self.voxel_cap, torch.clamp(inverse, 0, self.voxel_cap - 1)
        dt = self.linear0.weight.dtype
        x = torch.cat([points[:, 1:4], feats, _to_voxel(self, points, inverse, inv_safe)],
                      dim=-1).to(dt)
        zero = torch.zeros((), dtype=dt, device=x.device)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
            vmean = segment_ops.segment_mean(torch.where(valid[:, None], x, zero), inv_safe,
                                             cap + 1)[:cap]
            if i + 1 < self.num_layers:
                x = torch.cat([x, segment_ops.take_rows(vmean, rows)], dim=-1)
        bidx = torch.round(points[:, 0]).long()
        if self.umbrella is not None:
            surf = self.umbrella(points[:, 1:4].to(dt), bidx, valid)
        else:
            surf = umbrella_surface_features(points[:, 1:4], bidx, valid, k=self.knn).to(dt)
        vsurf = segment_ops.segment_mean(torch.where(valid[:, None], surf, zero), inv_safe,
                                         cap + 1)[:cap]
        batch_dict = _write_voxels(batch_dict, torch.cat([vmean, vsurf], dim=-1), coords, vvalid)
        batch_dict["point_voxel_inverse"] = inverse
        batch_dict["point_repsurf"] = surf
        return batch_dict


class TemporalVFE(nn.Module):
    """Temporal correspondence (no parameters): each point's nearest point
    within ``radius`` in the next sweep (the hash grid keyed by sweep, the
    query's sweep moved up by one), as sequence edges src -> dst with a
    validity mask, and ``point_xyz`` (the points with the sweep column set
    to 0); point features pass through. It writes no voxel table, so a
    detector's 3D backbone that follows it raises KeyError, as in JAX."""

    def __init__(self, voxel_size, point_cloud_range, voxel_cap, radius=0.5):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_cap, self.radius = int(voxel_cap), float(radius)

    def forward(self, batch_dict):
        from ..ops import hash_graph

        pts = batch_dict["point_bxyz"]
        n = pts.shape[0]
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=pts.device)
        q = pts.clone()
        q[:, 0] += 1.0
        grid = hash_graph.build_hash_grid(pts, self.radius, valid)
        idx, _, ok = hash_graph.radius_neighbors(grid, q, self.radius, 1, query_valid=valid)
        batch_dict["sequence_edge_src"] = torch.arange(n, dtype=torch.int64, device=pts.device)
        batch_dict["sequence_edge_dst"] = idx[:, 0]
        batch_dict["sequence_edge_valid"] = ok[:, 0]
        xyz = pts.clone()
        xyz[:, 0] = 0.0
        batch_dict["point_xyz"] = xyz
        return batch_dict


# the VFE names of the JAX package's VFES that the detector builds with
# (voxel_size, point_cloud_range, voxel_cap)
ZOO_VFES = {"DynamicVFE": DynamicVFE, "PlaneFitting": PlaneFittingVFE,
            "HybridVFE": PlaneFittingVFE, "RepsurfDynamicVFE": RepsurfDynamicVFE,
            "TemporalVFE": TemporalVFE}
