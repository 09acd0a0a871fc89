"""RoI heads (counterpart of pcseqlearning_tpu.models.roi_heads): the
proposal layer, RoI target assignment, the refinement decode and losses
that every two-stage model shares, and the pooled-feature heads
``VoxelRCNNHead``, ``PVRCNNHead``, ``PartA2FCHead``, ``PointRCNNHead`` and
``SECONDHead``.

No gradient is stopped: as in JAX, the RoI head's losses reach the dense
head through the RoIs (the grid points, the canonical-frame targets and
the 3D IoU in the targets). Gathers that carry a gradient go through
``segment_ops.take_rows``, whose backward is reproducible on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import boxes as box_ops
from ..ops import hash_graph, roi_pool, segment_ops
from ..ops.sampling import top_k
from ..utils import loss_utils
from ..utils.box_coder_utils import ResidualCoder
from .layers import MaskedBatchNorm
from .model_nms_utils import argsort_desc
from .pfe import voxel_centers
from .vfe import linear


def proposal_layer(pred_boxes, pred_scores, num_rois=128, nms_thresh=0.7, pre_max=1024):
    """One sample's RoIs: the top ``pre_max`` scores, rotated NMS, then the
    kept boxes by descending score, the rest after them in score order, cut
    to ``num_rois``. pred_boxes [A, 7], pred_scores [A] -> (rois [R, 7],
    roi_scores [R], roi_valid [R]), R = min(num_rois, pre_max, A)."""
    top_s, top_i = top_k(pred_scores, min(pre_max, pred_scores.shape[0]))
    cand = segment_ops.take_rows(pred_boxes, top_i)
    keep = box_ops.nms_bev(cand, top_s, nms_thresh)
    order = argsort_desc(torch.where(keep, top_s, torch.full_like(top_s, float("-inf"))))
    order = order[:num_rois]
    return segment_ops.take_rows(cand, order), top_s[order], keep[order]


def _canonical(rois):
    """The RoIs moved to the origin with no heading (their sizes kept)."""
    zeros = rois.new_zeros(rois.shape[0], 3)
    return torch.cat([zeros, rois[:, 3:6], zeros[:, :1]], dim=1)


def assign_roi_targets(rois, roi_valid, gt_boxes, gt_classes, gt_valid, fg_thresh=0.55,
                       bg_thresh=0.1, coder=None):
    """Each RoI's best GT by 3D IoU: (cls targets [R], the IoU scaled
    between bg_thresh and fg_thresh and clipped to [0, 1]; regression
    targets [R, 7] in the RoI's canonical frame, the heading residual
    wrapped, flipped by pi when opposite and clipped to +-pi/2; fg [R];
    best IoU [R]; best GT [R])."""
    coder = coder or ResidualCoder()
    iou = box_ops.boxes_iou3d(rois, gt_boxes)
    iou = torch.where(gt_valid[None, :] & roi_valid[:, None], iou, iou.new_tensor(-1.0))
    best = iou.amax(dim=1)
    arg = torch.argmax(iou, dim=1)
    tgt = gt_boxes[arg]
    cls_t = loss_utils.clip_split((best - bg_thresh) / (fg_thresh - bg_thresh), 0.0, 1.0)
    fg = best >= fg_thresh
    dxy = tgt[:, 0:2] - rois[:, 0:2]
    c, s = torch.cos(-rois[:, 6]), torch.sin(-rois[:, 6])
    lx = dxy[:, 0] * c - dxy[:, 1] * s
    ly = dxy[:, 0] * s + dxy[:, 1] * c
    two_pi = 2 * torch.pi
    dh = torch.remainder(tgt[:, 6] - rois[:, 6], two_pi)
    opposite = (dh > torch.pi * 0.5) & (dh < torch.pi * 1.5)
    dh = torch.where(opposite, torch.remainder(dh + torch.pi, two_pi), dh)
    dh = torch.where(dh > torch.pi, dh - two_pi, dh)
    dh = loss_utils.clip_split(dh, -torch.pi / 2, torch.pi / 2)
    local_tgt = torch.cat([torch.stack([lx, ly, tgt[:, 2] - rois[:, 2]], dim=-1), tgt[:, 3:6],
                           dh[:, None]], dim=-1)
    return cls_t, coder.encode(local_tgt, _canonical(rois)), fg, best, arg


def decode_roi_boxes(rois, reg_preds, coder=None):
    """Refined boxes [R, 7] from the canonical-frame residuals."""
    coder = coder or ResidualCoder()
    local = coder.decode(reg_preds, _canonical(rois))
    c, s = torch.cos(rois[:, 6]), torch.sin(rois[:, 6])
    gx = local[:, 0] * c - local[:, 1] * s + rois[:, 0]
    gy = local[:, 0] * s + local[:, 1] * c + rois[:, 1]
    return torch.cat([torch.stack([gx, gy, local[:, 2] + rois[:, 2]], dim=-1), local[:, 3:6],
                      (local[:, 6] + rois[:, 6])[:, None]], dim=-1)


def roi_head_loss(cls_preds, reg_preds, cls_t, reg_t, fg, roi_valid, code_weights=None):
    """(cls loss: BCE of the logits against the IoU-guided targets over the
    valid RoIs; reg loss: smooth-L1 over the valid foreground RoIs)."""
    v = roi_valid.to(cls_preds.dtype)
    nv = torch.clamp(v.sum(), min=1.0)
    bce = (loss_utils.relu_split(cls_preds) - cls_preds * cls_t
           + torch.log1p(torch.exp(-loss_utils.abs_(cls_preds))))
    fgw = (fg & roi_valid).to(cls_preds.dtype)
    nfg = torch.clamp(fgw.sum(), min=1.0)
    reg = loss_utils.weighted_smooth_l1_loss(reg_preds, reg_t, fgw / nfg, code_weights=code_weights)
    return (bce * v).sum() / nv, reg.sum()


class _FCHead(nn.Module):
    """The shared FC trunk (linear without bias, ``MaskedBatchNorm`` over the
    valid RoIs, ReLU per layer), then the cls (1) and reg (code_size)
    linears: flax's Dense_0 .. Dense_{n+1} as linear0 .. linear{n+1}."""

    def __init__(self, cin, shared=(256, 256), code_size=7, generator=None):
        super().__init__()
        self.num_shared = len(shared)
        for i, c in enumerate(shared):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c
        n = self.num_shared
        setattr(self, f"linear{n}", linear(cin, 1, bias=True, generator=generator))
        setattr(self, f"linear{n + 1}", linear(cin, code_size, bias=True, generator=generator))

    def forward(self, x, valid):
        for i in range(self.num_shared):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
        n = self.num_shared
        return getattr(self, f"linear{n}")(x)[:, 0], getattr(self, f"linear{n + 1}")(x)


class VoxelRCNNHead(nn.Module):
    """Voxel-query grid pooling: each RoI's G^3 grid points query the
    voxels of each source stage within its radius (the hash-grid search,
    ``nsample`` nearest, a scan cap of nsample + 16 a probe); each sample's
    offset and features go through a linear, ``MaskedBatchNorm`` and ReLU,
    then a max over the samples (a tie's gradient split evenly, as
    ``jnp.max``); the concatenated grid features feed ``_FCHead``."""

    STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
    # the JAX module's defaults, which no config changes
    FEATURES_SOURCE, POOL_RADIUS, NSAMPLE = ("x_conv3", "x_conv4"), (0.8, 1.6), 16

    def __init__(self, voxel_size, point_cloud_range, source_channels=(64, 64), grid_size=6,
                 generator=None):
        super().__init__()
        self.voxel_size, self.point_cloud_range = tuple(voxel_size), tuple(point_cloud_range)
        self.grid_size = grid_size
        for src, c in zip(self.FEATURES_SOURCE, source_channels):
            setattr(self, f"pool_{src}_fc", linear(3 + c, 32, generator=generator))
            setattr(self, f"pool_{src}_bn", MaskedBatchNorm(32))
        self.head = _FCHead(len(self.FEATURES_SOURCE) * 32 * grid_size ** 3, generator=generator)

    def forward(self, batch_dict, rois, roi_valid):
        r, g, k = rois.shape[0], self.grid_size, self.NSAMPLE
        grid_pts = roi_pool.roi_grid_points(rois, g).reshape(r * g ** 3, 3)
        roi_batch = batch_dict.get("roi_batch")
        if roi_batch is None:
            roi_batch = torch.zeros(r, dtype=torch.int64, device=rois.device)
        grid_b = torch.repeat_interleave(roi_batch, g ** 3)
        q_f = torch.cat([grid_b[:, None].to(torch.float32), grid_pts.detach().to(torch.float32)],
                        dim=1)
        pooled = []
        for src, radius in zip(self.FEATURES_SOURCE, self.POOL_RADIUS):
            st = batch_dict["multi_scale_3d_features"][src]
            centers = voxel_centers(st.coords, st.valid, self.voxel_size,
                                    self.point_cloud_range[:3], self.STRIDES[src])
            src_f = torch.cat([st.coords[:, 0:1].to(torch.float32), centers], dim=1)
            grid = hash_graph.build_hash_grid(src_f, radius, st.valid)
            idx, _, mask = hash_graph.radius_neighbors(grid, q_f, radius, k, cell_cap=k + 16)
            idx = torch.clamp(idx, 0, centers.shape[0] - 1).reshape(-1)
            m = mask.reshape(-1)
            rel = centers[idx].reshape(-1, k, 3).to(grid_pts.dtype) - grid_pts[:, None, :]
            gf = segment_ops.take_rows(st.features, idx)
            x = torch.cat([rel.reshape(-1, 3), gf], dim=-1)
            x = torch.where(m[:, None], x, x.new_zeros(()))
            h = getattr(self, f"pool_{src}_fc")(x)
            h = torch.relu(getattr(self, f"pool_{src}_bn")(h, m)).reshape(r * g ** 3, k, -1)
            h = torch.where(mask[..., None], h, torch.full_like(h, float("-inf")))
            hmax = h.amax(dim=1)
            pooled.append(torch.where(mask.any(1)[:, None], hmax, hmax.new_zeros(())))
        feat = torch.cat(pooled, dim=-1).reshape(r, -1)
        return self.head(feat, roi_valid)


class PVRCNNHead(nn.Module):
    """Keypoint grid pooling (reference pvrcnn_head.py): each RoI's G^3
    grid points query the VoxelSetAbstraction keypoints of their sample
    within ``pool_radius`` (the hash grid, ``nsample`` nearest, a scan cap
    of nsample + 16); each sample's offset and keypoint features go
    through a linear to 64, ``MaskedBatchNorm`` and ReLU, then a max over
    the samples (``amax``: a tie's gradient split evenly); the flattened
    grid feeds ``_FCHead``. ``kp_channels`` is the keypoint features'
    width. The offsets carry the gradient into the RoIs."""

    def __init__(self, kp_channels=128, grid_size=6, pool_radius=1.6, nsample=16,
                 generator=None):
        super().__init__()
        self.grid_size, self.pool_radius, self.nsample = grid_size, pool_radius, nsample
        self.linear0 = linear(3 + kp_channels, 64, generator=generator)
        self.norm0 = MaskedBatchNorm(64)
        self.head = _FCHead(64 * grid_size ** 3, generator=generator)

    def forward(self, batch_dict, rois, roi_valid):
        r, g, k = rois.shape[0], self.grid_size, self.nsample
        grid_pts = roi_pool.roi_grid_points(rois, g).reshape(r * g ** 3, 3)
        roi_batch = batch_dict.get("roi_batch")
        if roi_batch is None:
            roi_batch = torch.zeros(r, dtype=torch.int64, device=rois.device)
        grid_b = torch.repeat_interleave(roi_batch, g ** 3)
        kp_coords, kp_feats = batch_dict["point_coords"], batch_dict["point_features"]
        q_f = torch.cat([grid_b[:, None].to(torch.float32), grid_pts.detach().to(torch.float32)],
                        dim=1)
        grid = hash_graph.build_hash_grid(kp_coords.detach().to(torch.float32), self.pool_radius)
        idx, _, mask = hash_graph.radius_neighbors(grid, q_f, self.pool_radius, k,
                                                   cell_cap=k + 16)
        idx = torch.clamp(idx, 0, kp_coords.shape[0] - 1).reshape(-1)
        m = mask.reshape(-1)
        rel = (kp_coords.detach()[idx, 1:4].reshape(-1, k, 3).to(grid_pts.dtype)
               - grid_pts[:, None, :])
        gf = segment_ops.take_rows(kp_feats, idx)
        x = torch.cat([rel.reshape(-1, 3), gf], dim=-1)
        x = torch.where(m[:, None], x, x.new_zeros(()))
        h = torch.relu(self.norm0(self.linear0(x), m)).reshape(r * g ** 3, k, -1)
        h = torch.where(mask[..., None], h, torch.full_like(h, float("-inf")))
        hmax = h.amax(dim=1)
        hmax = torch.where(mask.any(1)[:, None], hmax, hmax.new_zeros(()))
        return self.head(hmax.reshape(r, -1), roi_valid)


class PartA2FCHead(nn.Module):
    """RoI-aware pooling head (reference parta2_head.py, as the JAX module
    has it): ``roiaware_pool3d`` with the average pool over the raw points'
    features (``point_feat``, width ``point_feature_channels``) in a 12^3
    grid per RoI (the JAX detector builds this head with its defaults, so
    the config's GRID_SIZE is not read), flattened into ``_FCHead``. As in
    JAX, every point of the batch pools into every RoI it falls in, whatever
    its sample; the RoIs enter through discrete cells only, so the head's
    losses give the dense head no gradient."""

    def __init__(self, point_feature_channels=1, grid_size=12, generator=None):
        super().__init__()
        self.grid_size = grid_size
        self.head = _FCHead(point_feature_channels * grid_size ** 3, generator=generator)

    def forward(self, batch_dict, rois, roi_valid):
        pts = batch_dict["point_bxyz"][:, 1:4]
        feats = batch_dict.get("point_feat")
        if feats is None:
            feats = pts.new_zeros((pts.shape[0], 1))
        pooled, _ = roi_pool.roiaware_pool3d(pts, feats, rois,
                                             point_valid=batch_dict.get("point_valid"),
                                             roi_valid=roi_valid, grid_size=self.grid_size,
                                             pool="avg")
        return self.head(pooled.reshape(rois.shape[0], -1), roi_valid)


class PointRCNNHead(nn.Module):
    """RoI point pooling head (reference pointrcnn_head.py, as the JAX
    module has it): each RoI pools ``num_sampled`` points of its own sample
    (``roipoint_pool3d_masked``) as rows [xyz centred on the RoI, the point
    features, the point's score, its depth |xyz| / 70 - 0.5], the xyz
    rotated into the RoI's frame; every row goes through the ``xyz_up`` and
    ``shared`` MLPs (linear without bias, ``MaskedBatchNorm`` over the rows
    of RoIs that are not empty, ReLU), then a max over the RoI's rows (0
    for an empty RoI) feeds ``_FCHead`` over the valid RoIs that are not
    empty. ``cin`` is the point features' width."""

    def __init__(self, cin, num_sampled=128, xyz_up=(128, 128), shared_mlp=(128, 256),
                 generator=None):
        super().__init__()
        self.num_sampled, self.num_up, self.num_shared = num_sampled, len(xyz_up), len(shared_mlp)
        c = 3 + cin + 2
        for i, cout in enumerate(xyz_up):
            setattr(self, f"xyz_up{i}", linear(c, cout, generator=generator))
            setattr(self, f"xyz_up_bn{i}", MaskedBatchNorm(cout))
            c = cout
        for i, cout in enumerate(shared_mlp):
            setattr(self, f"shared{i}", linear(c, cout, generator=generator))
            setattr(self, f"shared_bn{i}", MaskedBatchNorm(cout))
            c = cout
        self.head = _FCHead(c, generator=generator)

    def forward(self, batch_dict, rois, roi_valid):
        pts = batch_dict["point_bxyz"]
        xyz, bidx = pts[:, 1:4], torch.round(pts[:, 0]).long()
        n, r, s = xyz.shape[0], rois.shape[0], self.num_sampled
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=xyz.device)
        feats = batch_dict.get("point_features", batch_dict.get("point_feat"))
        if feats is None:
            feats = xyz.new_zeros((n, 1))
        scores = batch_dict.get("point_cls_scores")
        if scores is None:
            scores = xyz.new_ones(n)
        roi_b = batch_dict.get("roi_batch")
        if roi_b is None:
            roi_b = torch.zeros(r, dtype=torch.int64, device=rois.device)
        pair_valid = valid[None, :] & (bidx[None, :] == roi_b[:, None])
        depth = roi_pool._true_div(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)), 70.0) - 0.5
        ext = torch.cat([feats, scores[:, None].to(feats.dtype), depth.to(feats.dtype)], dim=-1)
        pooled, empty = roi_pool.roipoint_pool3d_masked(xyz, ext, rois, pair_valid, s)
        c, sn = torch.cos(-rois[:, 6])[:, None], torch.sin(-rois[:, 6])[:, None]
        lx = pooled[..., 0] * c - pooled[..., 1] * sn
        ly = pooled[..., 0] * sn + pooled[..., 1] * c
        h = torch.cat([torch.stack([lx, ly, pooled[..., 2]], dim=-1), pooled[..., 3:]], dim=-1)
        h = h.reshape(r * s, -1)
        flat_v = (~empty)[:, None].expand(r, s).reshape(-1)
        for name, num in (("xyz_up", self.num_up), ("shared", self.num_shared)):
            for i in range(num):
                bn = getattr(self, f"{name}_bn{i}")
                h = torch.relu(bn(getattr(self, f"{name}{i}")(h), flat_v))
        h = h.reshape(r, s, -1)
        feat = torch.where(empty[:, None, None], torch.full_like(h, float("-inf")), h).amax(dim=1)
        feat = torch.where(empty[:, None], feat.new_zeros(()), feat)
        return self.head(feat, roi_valid & ~empty)


class SECONDHead(PartA2FCHead):
    """The JAX package's SECONDHead: PartA2FCHead's RoI-aware pooling trunk
    under another name (no config names it)."""


ROI_HEADS = {"VoxelRCNNHead": VoxelRCNNHead, "PVRCNNHead": PVRCNNHead,
             "PartA2FCHead": PartA2FCHead, "PointRCNNHead": PointRCNNHead,
             "SECONDHead": SECONDHead}
