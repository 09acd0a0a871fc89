"""The detector's train step, on one card or data-parallel over the ranks
of a process group (counterpart of pcseqlearning_tpu.parallel.train_step).

A step runs the training forward (which updates the batch norms' running
statistics in place, as the JAX step keeps the forward's new
``batch_stats``), takes ``losses[loss_key]``, backpropagates, zeroes the
gradients of frozen parameters, reads the global L2 norm of the gradients
(``grad_norm``: before any clipping, as the JAX step's
``optax.global_norm(grads)``) and applies the optimizer: the one that
``runtime.optimization.build_optimizer`` makes (optax's clip, then Adam,
AdamW or SGD at the schedule's rate; it carries its update count, so a
loaded state resumes the schedule), by default the one it makes for
``OPTIMIZER: adam``, ``LR: 1e-3`` and no clip: ``optax.adam(1e-3)``.

Batches use the JAX layout: dense per-sample tables [B, N_cap, ...] with
validity masks (``dense_batch_from_collated``), flattened to the point
table with batch indices (``_flatten_local``).

Data parallel (``group`` of K ranks; the JAX step's shard_map over "dp"):
every rank gets the same global batch and takes its rows [r B / K,
(r + 1) B / K) (JAX's host input sharding; K must divide B). The forward
runs under ``bn_cross_replica(group)``, so every batch norm normalises by
the global batch's moments; the rank's own loss backpropagates (through the
moments' all-reduces), and the gradients are summed over the ranks as one
flat buffer and divided by K: the gradient of the mean of the ranks'
losses, which is what JAX differentiates (its pmean'd loss). The losses and
the batch norms' running statistics are averaged over the ranks (JAX's
pmean), and ``grad_norm`` and the freezing act on the reduced gradients, so
every rank takes the same update. One explicit all-reduce rather than
torch's DistributedDataParallel: it is deterministic, needs no buckets and
no unused-parameter search, and mirrors the JAX step line by line. The dp =
K step equals the dp = 1 step only where every shard holds the same number
of positives and of boxes (CenterHead normalises a shard's losses by its
own counts), no voxel cap cuts a sample, and no point is padding or out of
range (the VFE pools a shard's invalid points into one voxel of their own,
whose features enter the batch norms' moments): in JAX as here.
``dp_equivalence_issues`` checks a batch for all three.

With ``utils.profiler`` tracing, a step is the span ``train_step`` over
``train_step.forward`` (the batch to the device, flattening, the model
call), ``train_step.backward`` (``zero_grad``, ``.backward()`` and, with a
group, the ranks' reductions) and ``train_step.optimizer`` (freezing,
``global_norm``, the optimizer's step).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import bn_cross_replica
from ..runtime.optimization import build_optimizer, global_norm
from ..utils import dist_utils
from ..utils.profiler import span
from .mesh import rows_of


@dataclass
class TrainState:
    """The model (parameters and batch-norm statistics), its optimizer and
    the global step."""

    model: Any
    optimizer: Any
    step: int = 0


def dense_batch_from_collated(batch, n_cap, max_gt=128):
    """Collate output (flat point table with batch index) -> the dense
    layout: points [B, N_cap, 4] (batch index 0), feats [B, N_cap, C],
    valid [B, N_cap], gt_boxes [B, max_gt, 8], NumPy."""
    bxyz = np.asarray(batch["point_bxyz"])
    feat = np.asarray(batch.get("point_feat", np.zeros((len(bxyz), 1), np.float32)))
    B = int(batch["batch_size"])
    C = feat.shape[1]
    pts = np.zeros((B, n_cap, 4), np.float32)
    fts = np.zeros((B, n_cap, C), np.float32)
    val = np.zeros((B, n_cap), bool)
    for b in range(B):
        rows = np.nonzero(bxyz[:, 0].round().astype(int) == b)[0][:n_cap]
        n = len(rows)
        pts[b, :n] = bxyz[rows]
        pts[b, :n, 0] = 0
        fts[b, :n] = feat[rows]
        val[b, :n] = True
    gt = np.asarray(batch.get("gt_boxes", np.zeros((B, 1, 8), np.float32)))
    g = np.zeros((B, max_gt, gt.shape[-1]), np.float32)
    g[:, : min(gt.shape[1], max_gt)] = gt[:, :max_gt]
    return dict(points=pts, feats=fts, valid=val, gt_boxes=g)


def _flatten_local(points, feats, valid, gt_boxes):
    """[B, N, .] tensors -> the flat point table with batch indices."""
    b, n, _ = points.shape
    pts = points.clone()
    pts[:, :, 0] = torch.arange(b, dtype=points.dtype, device=points.device)[:, None]
    return {"point_bxyz": pts.reshape(b * n, 4), "point_feat": feats.reshape(b * n, -1),
            "point_valid": valid.reshape(b * n), "gt_boxes": gt_boxes, "batch_size": b}


def _to_device(batch, device):
    return {k: torch.as_tensor(batch[k]).to(device)
            for k in ("points", "feats", "valid", "gt_boxes")}


def init_train_state(model, make_optimizer=None, device="cuda", group=None):
    """TrainState for ``model`` on ``device`` (``"cuda"`` raises without a
    card); ``make_optimizer(params)`` (the first value that
    ``build_optimizer`` returns) defaults to ``optax.adam(1e-3)``'s. With a
    ``group``, every rank starts from rank 0's parameters and buffers."""
    dev = resolve_device(device)
    model = model.to(dev)
    if group is not None:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist_utils.broadcast(t.data, 0, group)
    if make_optimizer is None:
        make_optimizer, _ = build_optimizer({"OPTIMIZER": "adam", "LR": 1e-3,
                                             "GRAD_NORM_CLIP": math.inf})
    return TrainState(model, make_optimizer(model.parameters()), 0)


def _pmean_(tensors, group, world):
    """Average ``tensors`` in place over the ranks, as one flat all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist_utils.all_reduce(flat, group=group)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def param_path(name):
    """A parameter's name as the JAX step matches it: '/'-joined."""
    return name.replace(".", "/")


def make_train_step(loss_key="rpn_loss", freeze_regexes=(), freeze_until=0, device="cuda",
                    group=None):
    """The train step ``step(state, batch) -> (state, losses)`` on
    ``device`` (``"cuda"`` raises without a card). ``batch`` is the dense
    layout (NumPy or tensors); ``losses`` holds the head's losses and
    ``grad_norm``, as tensors on the device. ``freeze_regexes`` zero the
    gradients of parameters whose '/'-joined name matches while the step is
    below ``freeze_until`` (the reference's ZEROGRAD_MODULES). With a
    process ``group``, the step is data-parallel over its ranks (see the
    module docstring); each rank passes the same global batch."""
    dev = resolve_device(device)
    patterns = [re.compile(r) for r in freeze_regexes]
    rank, world = (0, 1) if group is None else dist_utils.get_dist_info(group)

    def train_step(state: TrainState, batch):
        with span("train_step"):
            model, opt = state.model, state.optimizer
            model.train()
            with span("train_step.forward"):
                if group is not None:
                    batch = {k: rows_of(batch[k], rank, world)
                             for k in ("points", "feats", "valid", "gt_boxes")}
                with bn_cross_replica(group):
                    out = model(_flatten_local(**_to_device(batch, dev)))
                losses = {k: v.detach() for k, v in out["losses"].items()}
            with span("train_step.backward"):
                opt.zero_grad()
                out["losses"][loss_key].backward()
                params = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
                if group is not None:
                    _pmean_([p.grad for _, p in params], group, world)
                    names = list(losses)
                    stacked = torch.stack([losses[k] for k in names])
                    _pmean_([stacked], group, world)
                    losses = dict(zip(names, stacked.unbind()))
                    with torch.no_grad():
                        _pmean_([b for b in model.buffers() if b.is_floating_point()], group,
                                world)
            with span("train_step.optimizer"):
                if patterns and state.step < freeze_until:
                    for name, p in params:
                        if any(pat.search(param_path(name)) for pat in patterns):
                            p.grad.zero_()
                losses["grad_norm"] = global_norm([p.grad for _, p in params])
                opt.step()
            state.step += 1
            return state, losses

    return train_step


def dp_equivalence_issues(model, batch, world):
    """(issues, fills): why the ``world``-rank step of ``batch`` (the
    dense layout) would differ from its one-rank step, as strings, empty
    when the two compute the same function (see the module docstring); and
    the (voxels, cap) of every capped voxel table of the one-rank step (the
    VFE's, then the strided sparse convs'), from one eval-mode forward of
    the VFE and the 3D backbone over the whole batch. A table filled to its
    cap counts as cut."""
    from ..models.layers import SparseConvBlock

    issues = []
    pts = torch.as_tensor(batch["points"])
    if pts.shape[0] % world:
        return [f"a batch of {pts.shape[0]} does not split into {world} shards"], []
    pcr = torch.tensor(model.vfe.point_cloud_range, dtype=pts.dtype)
    inside = ((pts[..., 1:4] >= pcr[:3]) & (pts[..., 1:4] < pcr[3:])).all(-1)
    bad = int((~(torch.as_tensor(batch["valid"]) & inside)).sum())
    if bad:
        issues.append(f"{bad} points are padding or out of range")
    dev = next(model.parameters()).device
    hm, _, _, mask = model.dense_head.head.build_targets(torch.as_tensor(batch["gt_boxes"]).to(dev))
    positives = (hm == 1.0).sum((1, 2, 3)).reshape(world, -1).sum(1).tolist()
    boxes = mask.sum(1).reshape(world, -1).sum(1).tolist()
    if len(set(positives)) > 1 or len(set(boxes)) > 1:
        issues.append(f"shards hold unequal positives {positives} or boxes {boxes}")
    fills = []
    hooks = [m.register_forward_hook(lambda m, i, o: fills.append((int(o.valid.sum()), m.out_cap)))
             for m in model.modules() if isinstance(m, SparseConvBlock) and m.out_cap]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            bd = model.vfe(_flatten_local(**_to_device(batch, dev)))
            fills.insert(0, (int(bd["voxel_valid"].sum()), model.vfe.voxel_cap))
            if model.backbone_3d is not None:
                model.backbone_3d(bd)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    cut = [f for f in fills if f[0] >= f[1]]
    if cut:
        issues.append(f"voxel tables filled to their caps (voxels, cap): {cut}")
    return issues, fills
