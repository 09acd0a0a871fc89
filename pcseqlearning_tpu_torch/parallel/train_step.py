"""The detector's train step on one card (counterpart of
pcseqlearning_tpu.parallel.train_step at dp = 1).

A step runs the training forward (which updates the batch norms' running
statistics in place, as the JAX step keeps the forward's new
``batch_stats``), takes ``losses[loss_key]``, backpropagates, zeroes the
gradients of frozen parameters, reads the global L2 norm of the gradients
and applies the optimizer (by default ``torch.optim.Adam(lr=1e-3,
eps=1e-8)``, the update of ``optax.adam(1e-3)``).

Batches use the JAX layout: dense per-sample tables [B, N_cap, ...] with
validity masks (``dense_batch_from_collated``), flattened to the point
table with batch indices (``_flatten_local``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


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


def init_train_state(model, make_optimizer=None, device="cuda"):
    """TrainState for ``model`` on ``device`` (``"cuda"`` raises without a
    card); ``make_optimizer(params)`` defaults to Adam(lr=1e-3, eps=1e-8)."""
    dev = resolve_device(device)
    model = model.to(dev)
    if make_optimizer is None:
        def make_optimizer(params):
            return torch.optim.Adam(params, lr=1e-3, eps=1e-8)
    return TrainState(model, make_optimizer(model.parameters()), 0)


def param_path(name):
    """A parameter's name as the JAX step matches it: '/'-joined."""
    return name.replace(".", "/")


def make_train_step(loss_key="rpn_loss", freeze_regexes=(), freeze_until=0, device="cuda"):
    """The train step ``step(state, batch) -> (state, losses)`` on
    ``device`` (``"cuda"`` raises without a card). ``batch`` is the dense
    layout (NumPy or tensors); ``losses`` holds the head's losses and
    ``grad_norm``, as tensors on the device. ``freeze_regexes`` zero the
    gradients of parameters whose '/'-joined name matches while the step is
    below ``freeze_until`` (the reference's ZEROGRAD_MODULES)."""
    dev = resolve_device(device)
    patterns = [re.compile(r) for r in freeze_regexes]

    def train_step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        model.train()
        out = model(_flatten_local(**_to_device(batch, dev)))
        losses = {k: v.detach() for k, v in out["losses"].items()}
        opt.zero_grad()
        out["losses"][loss_key].backward()
        params = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        if patterns and state.step < freeze_until:
            for name, p in params:
                if any(pat.search(param_path(name)) for pat in patterns):
                    p.grad.zero_()
        losses["grad_norm"] = torch.sqrt(sum((p.grad ** 2).sum() for _, p in params))
        opt.step()
        state.step += 1
        return state, losses

    return train_step
