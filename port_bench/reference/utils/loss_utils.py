"""Detection losses (counterpart of pcseqlearning_tpu.utils.loss_utils): the
anchor heads' and RoI heads' (sigmoid focal, smooth-L1, weighted
cross-entropy) and the CenterNet ones. ``weighted_l1_loss`` and the corner
loss wait for the heads that use them (ROADMAP.md, queue 1 item 4).

Gradients at ties follow JAX's: where JAX takes ``jnp.maximum`` /
``jnp.clip`` the port takes ``torch.maximum`` / ``torch.minimum``, which
split a tie's gradient evenly (``torch.clamp`` gives it all to the input),
and ``abs_`` has JAX's derivative +1 at 0 (``torch.abs`` has 0), which
counts where a prediction equals its target exactly."""

from __future__ import annotations

import torch


def abs_(x):
    """|x| with ``jnp.abs``'s gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def relu_split(x):
    """max(x, 0) with JAX's gradient at 0 (half)."""
    return torch.maximum(x, x.new_zeros(()))


def clip_split(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: max, then min, each splitting a tie's
    gradient evenly."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bce_with_logits(logits, targets):
    return relu_split(logits) - logits * targets + torch.log1p(torch.exp(-abs_(logits)))


def sigmoid_focal_cls_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Per-anchor focal loss: logits / targets [..., C], weights [...]
    (one per anchor). Returns the elementwise loss [..., C]."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    return alpha_w * torch.pow(pt, gamma) * _bce_with_logits(logits, targets) * weights[..., None]


def smooth_l1(diff, beta=1.0 / 9.0):
    ad = abs_(diff)
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def weighted_smooth_l1_loss(pred, target, weights, beta=1.0 / 9.0, code_weights=None):
    """[..., C] smooth-L1 of pred - target (times ``code_weights``), each
    row times its weight."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.tensor(code_weights, dtype=pred.dtype, device=pred.device)
    return smooth_l1(diff, beta) * weights[..., None]


def weighted_cross_entropy_loss(logits, one_hot_targets, weights):
    """Softmax cross-entropy [...] with a weight per row (the direction
    classifier's)."""
    return -(one_hot_targets * torch.log_softmax(logits, dim=-1)).sum(-1) * weights


def focal_loss_centernet(pred_sigmoid, gt_heatmap, eps=1e-4):
    """Penalty-reduced pixelwise focal loss (CornerNet / CenterNet form), a
    scalar over the number of positives."""
    pred = torch.clamp(pred_sigmoid, eps, 1.0 - eps)
    pos = gt_heatmap == 1.0
    neg_weights = torch.pow(1.0 - gt_heatmap, 4.0)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_weights * (~pos)
    num_pos = pos.to(pred.dtype).sum()
    loss = -(pos_loss.sum() + neg_loss.sum())
    return torch.where(num_pos > 0, loss / torch.clamp(num_pos, min=1.0), -neg_loss.sum())


def reg_loss_centernet(pred, target, mask):
    """Masked L1 of the regression targets at the GT centres, per channel:
    pred / target [B, K, C], mask [B, K]."""
    w = mask.to(pred.dtype)[..., None]
    return (abs_(pred - target) * w).sum((0, 1)) / torch.clamp(w.sum(), min=1.0)
