"""NMS front ends (counterpart of pcseqlearning_tpu.models.model_nms_utils):
class-agnostic and per-class NMS on ``ops.boxes.nms_bev``, and the ordering
helpers the detectors share.

Orderings follow JAX's: ``ops.sampling.top_k`` returns the lower index
first among equal values, as ``jax.lax.top_k`` does, and ``argsort_desc`` is
``jnp.argsort(-x)`` (stable). ``torch.topk`` promises neither on the card,
so both take a stable sort.
"""

from __future__ import annotations

import torch

from ..ops import boxes as box_ops
from ..ops.sampling import top_k


def argsort_desc(x):
    """``jnp.argsort(-x)``: descending, ties in index order."""
    return torch.sort(-x, stable=True).indices


def _keep_first(keep, scores, count):
    """The kept rows first, by descending score, then the others in index
    order: ``argsort(-where(keep, scores, -inf))[:count]``."""
    return argsort_desc(torch.where(keep, scores, torch.full_like(scores, float("-inf"))))[:count]


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """box_scores [A], box_preds [A, 7], nms_config with NMS_PRE_MAXSIZE /
    NMS_POST_MAXSIZE / NMS_THRESH. Returns (scores [post], boxes [post, 7],
    valid [post])."""
    pre = int(nms_config.get("NMS_PRE_MAXSIZE", 4096))
    post = int(nms_config.get("NMS_POST_MAXSIZE", 500))
    thresh = float(nms_config.get("NMS_THRESH", 0.7))
    scores = box_scores
    if score_thresh is not None:
        scores = torch.where(box_scores >= score_thresh, box_scores,
                             torch.full_like(box_scores, float("-inf")))
    top_s, top_i = top_k(scores, min(pre, box_scores.shape[0]))
    cand = box_preds[top_i]
    finite = torch.isfinite(top_s)
    keep = box_ops.nms_bev(cand, top_s, thresh, valid=finite)
    order = _keep_first(keep, top_s, post)
    return top_s[order], cand[order], keep[order] & finite[order]


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """Per-class NMS over cls_scores [A, C]: each class's (scores, labels
    from 1, boxes, valid), post_max rows a class, concatenated."""
    outs = []
    for c in range(cls_scores.shape[1]):
        s, b, v = class_agnostic_nms(cls_scores[:, c], box_preds, nms_config, score_thresh)
        outs.append((s, torch.full(s.shape, c + 1, dtype=torch.int32, device=s.device), b, v))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))
