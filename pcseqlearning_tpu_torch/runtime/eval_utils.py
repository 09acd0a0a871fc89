"""Detection recall and AP, Waymo-style AP/APH, and the segmentation IoU
table (counterpart of pcseqlearning_tpu.runtime.eval_utils), on host NumPy
and scipy as there; the 3D IoUs come from the port's ``ops.boxes`` on the
CPU.

``waymo_style_ap`` has the official estimator's semantics without
TensorFlow: per class, LEVEL_1 and LEVEL_2 difficulty and range buckets,
Hungarian matching per frame (``scipy.optimize.linear_sum_assignment`` on
the IoU), IoU thresholds 0.7 for vehicles and 0.5 otherwise, and APH
weighted by heading accuracy.
"""

from __future__ import annotations

import numpy as np
import torch


def _iou3d_np(boxes_a, boxes_b):
    from ..ops.boxes import boxes_iou3d

    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    return boxes_iou3d(torch.as_tensor(boxes_a.astype(np.float32)),
                       torch.as_tensor(boxes_b.astype(np.float32))).numpy()


def compute_recall(pred_boxes, gt_boxes, thresholds=(0.3, 0.5, 0.7)):
    """Recall of GT boxes by predictions at IoU thresholds: the GT count
    and, per threshold, the GTs whose best 3D IoU exceeds it."""
    out = {f"recall_{t}": 0 for t in thresholds}
    out["num_gt"] = len(gt_boxes)
    if len(gt_boxes) == 0:
        return out
    iou = _iou3d_np(gt_boxes[:, :7], pred_boxes[:, :7]) if len(pred_boxes) else np.zeros((len(gt_boxes), 0))
    best = iou.max(axis=1) if iou.shape[1] else np.zeros(len(gt_boxes))
    for t in thresholds:
        out[f"recall_{t}"] = int((best > t).sum())
    return out


def average_precision(scores, matched, num_gt):
    """11-point-free AP: precision envelope over recall."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    matched = np.asarray(matched)[order]
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(np.diff(np.concatenate([[0], recall])) > 0)[0]
    return float((precision[idx] * np.diff(np.concatenate([[0], recall]))[idx]).sum())


def simple_detection_eval(det_annos, gt_annos, class_names, iou_threshold=0.7):
    """Per-class AP with greedy IoU matching — the native metric path; use
    the official Waymo metrics for leaderboard numbers."""
    results = {}
    for ci, cname in enumerate(class_names):
        scores_all, matched_all, num_gt = [], [], 0
        for det, gt in zip(det_annos, gt_annos):
            det_mask = np.asarray(det["name"]) == cname
            det_boxes = np.asarray(det["boxes_lidar"])[det_mask]
            det_scores = np.asarray(det["score"])[det_mask]
            gt_names = np.asarray(gt.get("name", []))
            gt_mask = gt_names == cname
            gt_boxes = np.asarray(gt.get("gt_boxes_lidar", np.zeros((0, 7))))[gt_mask]
            num_gt += len(gt_boxes)
            if len(det_boxes) == 0:
                continue
            iou = _iou3d_np(det_boxes[:, :7], gt_boxes[:, :7])
            taken = np.zeros(len(gt_boxes), bool)
            m = np.zeros(len(det_boxes), bool)
            for i in np.argsort(-det_scores):
                if iou.shape[1] == 0:
                    break
                j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                if iou[i, j] > iou_threshold and not taken[j]:
                    taken[j] = True
                    m[i] = True
            scores_all.append(det_scores)
            matched_all.append(m)
        scores_all = np.concatenate(scores_all) if scores_all else np.zeros(0)
        matched_all = np.concatenate(matched_all) if matched_all else np.zeros(0, bool)
        results[f"{cname}_AP@{iou_threshold}"] = average_precision(scores_all, matched_all, num_gt)
    result_str = "\n".join(f"{k}: {v:.4f}" for k, v in results.items())
    return result_str, results


# ---------------------------------------------------------------------------
# Waymo-style detection metrics (native, TF-free)
# ---------------------------------------------------------------------------

_IOU_THRESH = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5, "Truck": 0.5, "Sign": 0.5}
_RANGE_BUCKETS = ((0.0, 30.0), (30.0, 50.0), (50.0, np.inf))


def _heading_accuracy(dt_heading, gt_heading):
    """Waymo heading accuracy in [0, 1]: 1 - |wrapped angle diff| / pi."""
    diff = np.abs(dt_heading - gt_heading) % (2 * np.pi)
    diff = np.minimum(diff, 2 * np.pi - diff)
    return np.maximum(0.0, 1.0 - diff / np.pi)


def _ap_from_matches(scores, tp_weight, h_weight, num_gt):
    """AP and APH from per-detection match weights (tp in {0,1}, h in [0,1]),
    precision-envelope integration (matching the official estimator's
    score-cutoff PR integral in the continuous limit).

    Tied scores are evaluated TOGETHER: the official estimator forms the PR
    curve at score cutoffs, so every detection with score >= cutoff enters
    the same PR point — a TP/FP pair sharing one score contributes a single
    (recall, precision) point, never an order-dependent intermediate one."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0, 0.0
    order = np.argsort(-scores)
    s = np.asarray(scores, np.float64)[order]
    tp = np.asarray(tp_weight, np.float64)[order]
    hw = np.asarray(h_weight, np.float64)[order]
    ctp = np.cumsum(tp)
    chw = np.cumsum(hw)
    cfp = np.cumsum(1.0 - tp)
    # PR points only at the LAST detection of each tied-score group
    last = np.concatenate([s[1:] != s[:-1], [True]])
    ctp, chw, cfp = ctp[last], chw[last], cfp[last]
    recall = ctp / num_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    precision_h = chw / np.maximum(ctp + cfp, 1e-9)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
        precision_h[i] = max(precision_h[i], precision_h[i + 1])
    dr = np.diff(np.concatenate([[0.0], recall]))
    return float((precision * dr).sum()), float((precision_h * dr).sum())


def waymo_style_ap(det_annos, gt_annos, class_names, with_range_breakdown=True):
    """Native Waymo-style detection metrics: per-class AP/APH at LEVEL_1 and
    LEVEL_2 difficulty plus range breakdowns, with per-frame Hungarian
    matching — semantics of the official estimator
    (OBJECT_TYPE breakdown, levels {1,2}, IoU 0.7 vehicle / 0.5 ped+cyc,
    TYPE_HUNGARIAN matcher, heading-weighted APH) without TensorFlow.

    det_annos[i]: dict(name [N], score [N], boxes_lidar [N, 7]).
    gt_annos[i]: dict(name [G], gt_boxes_lidar [G, 7], difficulty [G],
        num_points_in_gt [G] optional).
    Difficulty convention (the official estimator's): difficulty 0 becomes 1 when
    num_points_in_gt > 5 else 2; zero-point GTs are dropped.
    LEVEL_1 = difficulty-1 GTs (difficulty-2 GTs are don't-care);
    LEVEL_2 = all GTs.
    """
    from scipy.optimize import linear_sum_assignment

    results = {}
    for cname in class_names:
        thr = _IOU_THRESH.get(cname, 0.5)
        # per level: (scores, tp, hw, num_gt); range buckets at level 2
        acc = {"L1": [[], [], [], 0], "L2": [[], [], [], 0]}
        racc = {rb: [[], [], [], 0] for rb in _RANGE_BUCKETS}
        for det, gt in zip(det_annos, gt_annos):
            det_mask = np.asarray(det["name"]) == cname
            d_boxes = np.asarray(det["boxes_lidar"], np.float32)[det_mask]
            d_scores = np.asarray(det["score"], np.float32)[det_mask]
            gt_names = np.asarray(gt.get("name", []))
            g_mask = gt_names == cname
            g_boxes = np.asarray(gt.get("gt_boxes_lidar", np.zeros((0, 7))), np.float32)[g_mask]
            g_diff = np.asarray(gt.get("difficulty", np.zeros(len(gt_names))), np.int64)[g_mask]
            if "num_points_in_gt" in gt:
                npts = np.asarray(gt["num_points_in_gt"])[g_mask]
                g_diff = np.where((g_diff == 0) & (npts > 5), 1, g_diff)
                g_diff = np.where((g_diff == 0), 2, g_diff)
                keep = npts > 0
                g_boxes, g_diff = g_boxes[keep], g_diff[keep]
            else:
                g_diff = np.where(g_diff == 0, 1, g_diff)

            # Hungarian match maximizing total IoU, then threshold
            iou = _iou3d_np(d_boxes[:, :7], g_boxes[:, :7])
            match_gt = np.full(len(d_boxes), -1, np.int64)
            if iou.size:
                ri, ci = linear_sum_assignment(-iou)
                for i, j in zip(ri, ci):
                    if iou[i, j] >= thr:
                        match_gt[i] = j
            hacc = np.zeros(len(d_boxes))
            mm = match_gt >= 0
            if mm.any():
                hacc[mm] = _heading_accuracy(
                    d_boxes[mm, 6], g_boxes[match_gt[mm], 6]
                )
            g_range = np.linalg.norm(g_boxes[:, :2], axis=1) if len(g_boxes) else np.zeros(0)
            d_range = np.linalg.norm(d_boxes[:, :2], axis=1) if len(d_boxes) else np.zeros(0)

            for level, gsel in (("L1", g_diff <= 1), ("L2", g_diff <= 2)):
                # dets matched to out-of-level GTs are don't-care (dropped)
                msel = np.zeros(len(d_boxes), bool)
                msel[mm] = gsel[match_gt[mm]]
                care = ~mm | msel
                tp = msel
                acc[level][0].append(d_scores[care])
                acc[level][1].append(tp[care].astype(np.float64))
                acc[level][2].append((hacc * tp)[care])
                acc[level][3] += int(gsel.sum())
            if with_range_breakdown:
                for rb in _RANGE_BUCKETS:
                    gsel = (g_range >= rb[0]) & (g_range < rb[1])
                    in_rb = (d_range >= rb[0]) & (d_range < rb[1])
                    msel = np.zeros(len(d_boxes), bool)
                    msel[mm] = gsel[match_gt[mm]]
                    care = (~mm & in_rb) | msel
                    tp = msel
                    racc[rb][0].append(d_scores[care])
                    racc[rb][1].append(tp[care].astype(np.float64))
                    racc[rb][2].append((hacc * tp)[care])
                    racc[rb][3] += int(gsel.sum())

        for level in ("L1", "L2"):
            s, t, h, ng = acc[level]
            s = np.concatenate(s) if s else np.zeros(0)
            t = np.concatenate(t) if t else np.zeros(0)
            h = np.concatenate(h) if h else np.zeros(0)
            ap, aph = _ap_from_matches(s, t, h, ng)
            results[f"{cname}/{level}/AP"] = ap
            results[f"{cname}/{level}/APH"] = aph
        if with_range_breakdown:
            for rb in _RANGE_BUCKETS:
                s, t, h, ng = racc[rb]
                s = np.concatenate(s) if s else np.zeros(0)
                t = np.concatenate(t) if t else np.zeros(0)
                h = np.concatenate(h) if h else np.zeros(0)
                ap, aph = _ap_from_matches(s, t, h, ng)
                hi = "INF" if np.isinf(rb[1]) else f"{rb[1]:.0f}"
                results[f"{cname}/RANGE_[{rb[0]:.0f},{hi})/AP"] = ap
                results[f"{cname}/RANGE_[{rb[0]:.0f},{hi})/APH"] = aph

    result_str = "\n".join(f"{k}: {v:.4f}" for k, v in sorted(results.items()))
    return result_str, results


def segmentation_iou_table(pred_labels, gt_labels, num_classes, class_names=None):
    """Per-class IoU and their mean over the classes present."""
    ious = {}
    valid = gt_labels >= 0
    pred, gt = pred_labels[valid], gt_labels[valid]
    for c in range(num_classes):
        inter = int(((pred == c) & (gt == c)).sum())
        union = int(((pred == c) | (gt == c)).sum())
        name = class_names[c] if class_names else str(c)
        ious[name] = inter / union if union else float("nan")
    vals = [v for v in ious.values() if v == v]
    ious["mIoU"] = float(np.mean(vals)) if vals else float("nan")
    return ious
