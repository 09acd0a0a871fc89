"""Additional heads (counterpart of pcseqlearning_tpu.models.extra_heads):
the multi-group anchor head, PartA2's part-offset point head, the voxel,
embedding, primitive and hybrid segmentation heads with the Lovasz-softmax
loss, and the implicit and point-sequence reconstruction heads. No config
names them; the heads build with explicit input widths.

``ImplicitReconstructionHead.loss`` matches each sample to its angularly
nearest lidar return with ``ops.pair_min`` at C = 1 (P = 27 n samples, Q =
n returns), which on the card launches the kernel's streamed mode.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import segment_ops
from ..ops.boxes import points_in_boxes
from ..ops.pair_min import pair_min
from ..utils.loss_utils import abs_, clip_split, relu_split, sigmoid_focal_cls_loss
from .backbones_2d import conv2d
from .dense_heads import AnchorHeadSingle
from .layers import MaskedBatchNorm
from .vfe import linear


def _valid(batch_dict, key, n, device):
    v = batch_dict.get(key)
    return torch.ones(n, dtype=torch.bool, device=device) if v is None else v


class _MLP(nn.Module):
    """``linear<i>`` (no bias), ``norm<i>`` (``MaskedBatchNorm``), ReLU per
    hidden width: flax's auto-named Dense_i / MaskedBatchNorm_i."""

    def __init__(self, cin, hidden, generator=None):
        super().__init__()
        for i, c in enumerate(hidden):
            setattr(self, f"linear{i}", linear(cin, c, generator=generator))
            setattr(self, f"norm{i}", MaskedBatchNorm(c))
            cin = c
        self.num_hidden, self.width = len(hidden), cin

    def trunk(self, x, valid):
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"linear{i}")(x), valid))
        return x

    def add_outputs(self, widths, generator):
        """The output layers (linear with bias) after the hidden ones."""
        for j, c in enumerate(widths):
            setattr(self, f"linear{self.num_hidden + j}",
                    linear(self.width, c, bias=True, generator=generator))

    def out(self, j, h):
        return getattr(self, f"linear{self.num_hidden + j}")(h)


class AnchorHeadMulti(AnchorHeadSingle):
    """AnchorHeadSingle after a shared 3x3 conv (``shared_conv``, no bias,
    ReLU) to ``shared_channels``; the same targets and losses."""

    def __init__(self, input_channels, num_classes, grid_size_xy, point_cloud_range, anchor_cfgs,
                 shared_channels=64, predict_iou=False, generator=None):
        super().__init__(shared_channels, num_classes, grid_size_xy, point_cloud_range,
                         anchor_cfgs, predict_iou=predict_iou, generator=generator)
        self.shared_conv = conv2d(input_channels, shared_channels, 3, padding=1,
                                  generator=generator)

    def forward(self, batch_dict):
        batch_dict = dict(batch_dict)
        batch_dict["spatial_features_2d"] = torch.relu(
            self.shared_conv(batch_dict["spatial_features_2d"]))
        return super().forward(batch_dict)


class PointIntraPartOffsetHead(_MLP):
    """PartA2's point head: per-point class logits and sigmoid part
    locations in [0, 1]^3 from an MLP over ``point_features``."""

    def __init__(self, cin, num_classes, hidden=(128, 128), generator=None):
        super().__init__(cin, hidden, generator)
        self.add_outputs((num_classes, 3), generator)

    def forward(self, batch_dict):
        x = batch_dict["point_features"]
        h = self.trunk(x, _valid(batch_dict, "point_valid", x.shape[0], x.device))
        batch_dict["point_cls_preds"] = self.out(0, h)
        batch_dict["point_part_preds"] = torch.sigmoid(self.out(1, h))
        return batch_dict

    @staticmethod
    def build_targets(point_coords, gt_boxes_b):
        """One sample's labels (the first box holding the point, class > 0)
        and part coordinates in [0, 1]^3 of the points in a box."""
        boxes = gt_boxes_b[:, :7]
        cls = gt_boxes_b[:, 7].to(torch.int64)
        bp = points_in_boxes(point_coords[:, 1:4], boxes) & (cls > 0)[:, None]
        in_any = bp.any(0)
        bid = torch.argmax(bp.to(torch.uint8), dim=0)
        b = boxes[bid]
        d = point_coords[:, 1:4] - b[:, 0:3]
        c, s = torch.cos(-b[:, 6]), torch.sin(-b[:, 6])
        local = torch.stack([d[:, 0] * c - d[:, 1] * s, d[:, 0] * s + d[:, 1] * c, d[:, 2]], -1)
        local = local / torch.clamp(b[:, 3:6], min=1e-4) + 0.5
        part = torch.clamp(local, 0.0, 1.0)
        labels = torch.where(in_any, cls[bid], torch.zeros_like(cls[bid]))
        return labels, torch.where(in_any[:, None], part, part.new_zeros(()))

    @staticmethod
    def loss(batch_dict, gt_boxes):
        """(focal class loss over the valid points / positives, BCE of the
        part locations over the positives' 3 channels)."""
        logits, parts = batch_dict["point_cls_preds"], batch_dict["point_part_preds"]
        coords = batch_dict["point_coords"]
        n, nc = logits.shape
        valid = _valid(batch_dict, "point_valid", n, logits.device)
        bidx = torch.round(coords[:, 0]).long()
        labels = torch.zeros(n, dtype=torch.int64, device=logits.device)
        part_t = torch.zeros_like(parts)
        for b in range(gt_boxes.shape[0]):
            lb, pt = PointIntraPartOffsetHead.build_targets(coords, gt_boxes[b])
            m = bidx == b
            labels = torch.where(m, lb, labels)
            part_t = torch.where(m[:, None], pt.to(parts.dtype), part_t)
        onehot = torch.nn.functional.one_hot(torch.clamp(labels, min=0), nc + 1)[:, 1:]
        pos = (labels > 0) & valid
        num_pos = torch.clamp(pos.sum(), min=1)
        w = valid.to(logits.dtype) / num_pos
        cls_loss = sigmoid_focal_cls_loss(logits, onehot.to(logits.dtype), w).sum()
        p = clip_split(parts, 1e-6, 1 - 1e-6)
        bce = -(part_t * torch.log(p) + (1 - part_t) * torch.log(1 - p))
        part_loss = (bce * pos[:, None]).sum() / torch.clamp(pos.sum() * 3, min=1)
        return cls_loss, part_loss


class VoxelSegHead(_MLP):
    """Voxel semantic segmentation: logits from an MLP over
    ``voxel_point_features`` (or ``voxel_features``)."""

    def __init__(self, cin, num_classes, hidden=(64,), generator=None):
        super().__init__(cin, hidden, generator)
        self.add_outputs((num_classes,), generator)

    def forward(self, batch_dict):
        x = batch_dict.get("voxel_point_features", batch_dict["voxel_features"])
        batch_dict["seg_logits"] = self.out(0, self.trunk(x, batch_dict["voxel_valid"]))
        return batch_dict

    @staticmethod
    def loss(batch_dict, labels, valid, use_lovasz=False):
        """Cross-entropy over the valid rows with a label >= 0 (plus
        ``lovasz_softmax`` with ``use_lovasz``)."""
        logits = batch_dict["seg_logits"]
        nc = logits.shape[-1]
        onehot = torch.nn.functional.one_hot(torch.clamp(labels.long(), 0, nc - 1), nc)
        logp = torch.log_softmax(logits, dim=-1)
        w = (valid & (labels >= 0)).to(logits.dtype)
        ce = -(onehot * logp).sum(-1) * w
        total = ce.sum() / torch.clamp(w.sum(), min=1.0)
        if use_lovasz:
            total = total + lovasz_softmax(torch.softmax(logits, -1), labels, valid)
        return total


def lovasz_softmax(probs, labels, valid):
    """Lovasz-softmax surrogate of the IoU: per class, the valid rows'
    errors sorted in descending order (stable) against the Jaccard
    gradient; the mean over classes."""
    nc = probs.shape[-1]
    vf = valid.to(probs.dtype)
    losses = []
    for c in range(nc):
        fg = ((labels == c) & valid).to(probs.dtype)
        errors = abs_(fg - probs[:, c]) * vf
        order = torch.sort(-errors, stable=True).indices
        fg_sorted = fg[order]
        gts = fg.sum()
        inter = gts - torch.cumsum(fg_sorted, 0)
        union = gts + torch.cumsum(1.0 - fg_sorted, 0)
        jaccard = 1.0 - inter / torch.clamp(union, min=1e-6)
        grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        losses.append((errors[order] * grad).sum() / torch.clamp(vf.sum(), min=1.0))
    return torch.stack(losses).mean()


class EmbedSegHead(_MLP):
    """Semantic logits and per-point instance embeddings from an MLP over
    ``voxel_point_features`` (or ``point_features``)."""

    def __init__(self, cin, num_classes, embed_dim=16, hidden=(64,), generator=None):
        super().__init__(cin, hidden, generator)
        self.add_outputs((num_classes, embed_dim), generator)

    def forward(self, batch_dict):
        x = batch_dict.get("voxel_point_features", batch_dict.get("point_features"))
        valid = batch_dict.get("voxel_valid", batch_dict.get("point_valid"))
        h = self.trunk(x, valid)
        batch_dict["seg_logits"] = self.out(0, h)
        batch_dict["seg_embedding"] = self.out(1, h)
        return batch_dict

    @staticmethod
    def discriminative_loss(embed, instance_ids, valid, num_instances, delta_v=0.5,
                            delta_d=1.5):
        """Pull each embedding to within ``delta_v`` of its instance's
        centroid, push the centroids ``2 delta_d`` apart."""
        real = valid & (instance_ids >= 0)
        ids = torch.where(real, instance_ids.long(), torch.full_like(instance_ids.long(),
                                                                     num_instances))
        centroids = segment_ops.segment_mean(embed, ids, num_instances + 1)[:num_instances]
        has = segment_ops.segment_count(ids, num_instances + 1)[:num_instances] > 0.5
        rows = torch.clamp(instance_ids.long(), 0, num_instances - 1)
        d = torch.linalg.norm(embed - segment_ops.take_rows(centroids, rows), dim=-1)
        pull = relu_split(d - delta_v) ** 2
        pull = torch.where(real, pull, pull.new_zeros(())).sum() / torch.clamp(real.sum(), min=1)
        cd = torch.linalg.norm(centroids[:, None] - centroids[None, :], dim=-1)
        eye = torch.eye(num_instances, dtype=torch.bool, device=embed.device)
        pair = has[:, None] & has[None, :] & ~eye
        push = relu_split(2 * delta_d - cd) ** 2
        push = torch.where(pair, push, push.new_zeros(())).sum() / torch.clamp(pair.sum(), min=1)
        return pull + push


class PrimitiveHead(_MLP):
    """Per-voxel plane normal (unit) and offset from an MLP over
    ``voxel_features``."""

    def __init__(self, cin, hidden=(64,), generator=None):
        super().__init__(cin, hidden, generator)
        self.add_outputs((4,), generator)

    def forward(self, batch_dict):
        raw = self.out(0, self.trunk(batch_dict["voxel_features"], batch_dict["voxel_valid"]))
        n = raw[:, :3]
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
        batch_dict["primitive_normal_preds"] = n
        batch_dict["primitive_offset_preds"] = raw[:, 3]
        return batch_dict

    @staticmethod
    def loss(batch_dict, gt_normals, valid):
        """1 - |cos| between predicted and true normals over the valid rows."""
        n = batch_dict["primitive_normal_preds"]
        cos = abs_((n * gt_normals).sum(-1))
        return ((1.0 - cos) * valid.to(n.dtype)).sum() / torch.clamp(valid.sum(), min=1)


class HybridSegHead(_MLP):
    """Class-balanced point segmentation: logits from an FC stack over
    ``point_features``; cross-entropy weighted by 1 / max(count of the
    point's class, 20)."""

    def __init__(self, cin, num_classes, fc=(256, 256), generator=None):
        super().__init__(cin, fc, generator)
        self.add_outputs((num_classes,), generator)

    def forward(self, batch_dict):
        x = batch_dict["point_features"]
        h = self.trunk(x, _valid(batch_dict, "point_valid", x.shape[0], x.device))
        batch_dict["pred_seg_cls_logits"] = self.out(0, h)
        return batch_dict

    @staticmethod
    def loss(batch_dict, labels, valid):
        logits = batch_dict["pred_seg_cls_logits"]
        c = logits.shape[-1]
        lab = torch.clamp(labels.long(), 0, c - 1)
        ok = (valid & (labels >= 0)).to(torch.float32)
        counts = segment_ops.segment_sum(ok, lab, c)
        w = ok / torch.clamp(counts[lab], min=20.0)
        ce = -torch.gather(torch.log_softmax(logits, dim=-1), 1, lab[:, None])[:, 0]
        return (ce * w.to(ce.dtype)).sum()


def _latent(head, cin, latent, generator):
    for i, c in enumerate(latent):
        setattr(head, f"latent{i}", linear(cin, c, generator=generator))
        setattr(head, f"latent_bn{i}", MaskedBatchNorm(c))
        cin = c
    head.num_latent = len(latent)
    return cin


def _run_latent(head, x, valid):
    for i in range(head.num_latent):
        x = torch.relu(getattr(head, f"latent_bn{i}")(getattr(head, f"latent{i}")(x), valid))
    return x


def _spherical(p):
    """(range, polar angle from +z, azimuth) of [..., 3] points; the range at
    least 1e-4."""
    rho = torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-4)
    polar = torch.arccos(torch.clamp(p[..., 2] / rho, -1.0, 1.0))
    return rho, polar, torch.atan2(p[..., 1], p[..., 0])


class ImplicitReconstructionHead(nn.Module):
    """Implicit occupancy around each point: a regular s^3 grid of offsets
    in [-radius / 2, radius / 2]^3 (s = ``num_samples_per_dim``), each
    classified from the point's latent feature (``latent<i>``,
    ``latent_bn<i>``, ReLU) and the offset (``occ``, linear with bias)."""

    def __init__(self, cin, latent=(128, 64), num_samples_per_dim=3, radius=0.4,
                 generator=None):
        super().__init__()
        s = num_samples_per_dim
        lin = np.linspace(-radius / 2, radius / 2, s, dtype=np.float32)
        grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
        self.register_buffer("offsets", torch.from_numpy(grid), persistent=False)
        c = _latent(self, cin, latent, generator)
        self.occ = linear(c + 3, 1, bias=True, generator=generator)

    def forward(self, batch_dict):
        x = batch_dict["point_features"]
        xyz = batch_dict["point_coords"][:, 1:4]
        n = x.shape[0]
        h = _run_latent(self, x, _valid(batch_dict, "point_valid", n, x.device))
        offs = self.offsets.to(h.dtype)
        S = offs.shape[0]
        oin = torch.cat([h[:, None, :].expand(n, S, h.shape[-1]), offs[None].expand(n, S, 3)], -1)
        batch_dict["rec_occupancy_logits"] = self.occ(oin)[..., 0]
        batch_dict["rec_sample_xyz"] = xyz[:, None, :] + offs[None].to(xyz.dtype)
        return batch_dict

    @staticmethod
    def loss(batch_dict, spherical_radius=0.04):
        """BCE against spherical-projection visibility labels: each sample
        is matched to the valid return nearest in (1e3 * batch, polar,
        azimuth) (``pair_min`` at C = 1 on float32 keys, by direct
        differences); it is
        occupied iff its projection on that return's ray reaches the
        return's range, and weighted by the angular certainty
        max(spherical_radius - angular distance, 0) / spherical_radius."""
        logits = batch_dict["rec_occupancy_logits"]  # [N, S]
        samples = batch_dict["rec_sample_xyz"]  # [N, S, 3]
        xyz = batch_dict["point_coords"][:, 1:4]
        bidx = batch_dict["point_coords"][:, 0]
        n, S = logits.shape
        valid = _valid(batch_dict, "point_valid", n, logits.device)
        sval = valid[:, None].expand(n, S).reshape(1, -1)
        rho, pol, az = _spherical(xyz)
        flat_s = samples.reshape(n * S, 3)
        _, spol, saz = _spherical(flat_s)
        ref_key = torch.stack([bidx * 1e3, pol, az], dim=-1)
        q_key = torch.stack([bidx[:, None].expand(n, S).reshape(-1) * 1e3, spol, saz], dim=-1)
        with torch.no_grad():
            fd, fj, _, _ = pair_min(q_key[None].float().contiguous(),
                                    ref_key[None].float().contiguous(), sval.contiguous(),
                                    valid[None].contiguous())
        sdist = torch.sqrt(torch.clamp(fd[0], min=0.0)).to(logits.dtype)
        e_ref = torch.clamp(fj[0].long(), 0, n - 1)
        certainty = (torch.clamp(spherical_radius - sdist, min=0.0) / spherical_radius)
        lidar_dir = xyz[e_ref] / rho[e_ref][:, None]
        proj_dist = torch.abs((flat_s * lidar_dir).sum(-1))
        occ = (rho[e_ref] <= proj_dist).to(logits.dtype).reshape(n, S)
        w = valid[:, None].to(logits.dtype) * certainty.reshape(n, S)
        bce = relu_split(logits) - logits * occ + torch.log1p(torch.exp(-abs_(logits)))
        return (bce * w).sum() / torch.clamp(valid.to(logits.dtype).sum() * S, min=1.0)


class PointSequenceReconstructionHead(nn.Module):
    """Each point predicts ``num_predicted_points`` offsets (``latent<i>``,
    ``latent_bn<i>``, ReLU, ``predictor`` linear with bias) that must
    Chamfer-match its true nearest neighbourhood."""

    def __init__(self, cin, latent=(128, 64), num_predicted_points=8, radius=1.0,
                 generator=None):
        super().__init__()
        self.num_predicted_points = num_predicted_points
        c = _latent(self, cin, latent, generator)
        self.predictor = linear(c, num_predicted_points * 3, bias=True, generator=generator)

    def forward(self, batch_dict):
        x = batch_dict["point_features"]
        n = x.shape[0]
        h = _run_latent(self, x, _valid(batch_dict, "point_valid", n, x.device))
        batch_dict["rec_pred_nbrhood"] = self.predictor(h).reshape(n, self.num_predicted_points,
                                                                   3)
        return batch_dict

    @staticmethod
    def loss(batch_dict, radius=1.0):
        """Symmetric Chamfer between the predicted offsets and the offsets of
        the K nearest valid points (itself included) within ``radius``."""
        from ..ops import sampling

        pred = batch_dict["rec_pred_nbrhood"]  # [N, K, 3]
        xyz = batch_dict["point_coords"][:, 1:4]
        n, K, _ = pred.shape
        valid = _valid(batch_dict, "point_valid", n, pred.device)
        with torch.no_grad():
            idx, d2 = sampling.knn_bruteforce(xyz, xyz, K, ref_valid=valid)
        gt = (xyz[torch.clamp(idx, 0, n - 1)] - xyz[:, None, :]).to(pred.dtype)
        gt_ok = (idx >= 0) & (d2 <= radius * radius) & valid[:, None]
        dd = ((pred[:, :, None, :] - gt[:, None, :, :]) ** 2).sum(-1)  # [N, Kp, Kg]
        fwd = torch.where(gt_ok[:, None, :], dd, torch.full_like(dd, float("inf"))).amin(2)
        fwd = torch.where(gt_ok.any(1)[:, None], fwd, fwd.new_zeros(()))
        bwd = torch.where(gt_ok, dd.amin(1), dd.new_zeros(()))
        w = valid.to(pred.dtype)
        per = fwd.mean(1) + bwd.sum(1) / torch.clamp(gt_ok.sum(1), min=1)
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


EXTRA_HEADS = {"AnchorHeadMulti": AnchorHeadMulti,
               "PointIntraPartOffsetHead": PointIntraPartOffsetHead,
               "VoxelSegHead": VoxelSegHead, "EmbedSegHead": EmbedSegHead,
               "PrimitiveHead": PrimitiveHead, "HybridSegHead": HybridSegHead,
               "ImplicitReconstructionHead": ImplicitReconstructionHead,
               "PointSequenceReconstructionHead": PointSequenceReconstructionHead}
