"""Interaction-index masks and the AP/APH broken down by interaction-index
level (counterpart of pcseqlearning_tpu.datasets.waymo_eval_ii), on host
NumPy and scipy.

A box "interacts" at radius r when its box grown by r holds foreground
points that are neither its own members nor of its instance
(``check_box_interaction``; road and sidewalk points never count). A box's
level is the position of the smallest radius it interacts at in the ladder
``II_DIFFICULTIES`` read from the largest down (level 0: it interacts at
none). ``ap_by_interaction_index`` scores detections per group of levels:
a GT box outside the group is don't-care for that group, and matching is
Hungarian on the 3D IoU (``runtime.eval_utils``' helpers).
"""

from __future__ import annotations

import numpy as np

II_DIFFICULTIES = (0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 2.0, 4.0, 6.0, 8.0)

_ROAD_CLS = 10
_SIDEWALK_CLS = 11


def split_by_seg_label(points, labels):
    """(road xyz, sidewalk xyz, other xyz, other labels) by the segment
    class ``labels[:, 1]``."""
    points = points[:labels.shape[0]]
    seg = labels[:, 1]
    road_m = seg == _ROAD_CLS
    side_m = seg == _SIDEWALK_CLS
    other_m = ~road_m & ~side_m
    return points[road_m, :3], points[side_m, :3], points[other_m, :3], labels[other_m]


def _points_in_boxes_np(points, boxes):
    """[B, N] bool: point n strictly inside rotated box b."""
    if len(points) == 0 or len(boxes) == 0:
        return np.zeros((len(boxes), len(points)), bool)
    d = points[None, :, :3] - boxes[:, None, :3]
    c = np.cos(-boxes[:, 6])[:, None]
    s = np.sin(-boxes[:, 6])[:, None]
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    return ((np.abs(lx) < boxes[:, None, 3] / 2) & (np.abs(ly) < boxes[:, None, 4] / 2)
            & (np.abs(d[..., 2]) < boxes[:, None, 5] / 2))


def check_box_interaction(boxes, radius, other_obj, seg_labels):
    """[B] bool: the box grown by ``radius`` holds a point that is not one
    of its members and not of its instance (the median instance label of
    its members, -1 without members)."""
    expected = _points_in_boxes_np(other_obj, boxes)
    box_inst = np.zeros(len(boxes), np.int64)
    for i in range(len(boxes)):
        m = expected[i]
        box_inst[i] = np.median(seg_labels[m, 0]) if m.any() else -1
    enlarged = boxes.copy()
    enlarged[:, 3:6] += radius
    inter = _points_in_boxes_np(other_obj, enlarged)
    inter[expected] = False
    bi, pi = np.nonzero(inter)
    same = box_inst[bi] == seg_labels[pi, 0]
    inter[bi[same], pi[same]] = False
    return inter.any(axis=1)


def compute_interaction_index(points, seg_labels, boxes, radius_list=II_DIFFICULTIES):
    """{str(radius): [B] bool} interaction masks of one frame."""
    if len(boxes) == 0:
        return {str(r): np.zeros(0, bool) for r in radius_list}
    _, _, other_obj, other_lab = split_by_seg_label(points, seg_labels)
    return {str(r): check_box_interaction(boxes, r, other_obj, other_lab) for r in radius_list}


def ii_difficulty_levels(interaction_index, num_boxes):
    """[B] int32 levels from the per-radius masks (level 0: no radius)."""
    levels = np.zeros(num_boxes, np.int32)
    for level, r in enumerate(reversed(II_DIFFICULTIES)):
        key = str(r)
        if key in interaction_index:
            levels[np.asarray(interaction_index[key], bool)] = level + 1
    return levels


def ap_by_interaction_index(det_annos, gt_annos, class_names,
                            level_groups=((0,), (1, 2, 3), (4, 5, 6, 7, 8, 9, 10, 11))):
    """(result_str, {"<class>/II_<levels>/AP" and "/APH": value}). The
    GT annos carry ``interaction_index`` dicts."""
    from scipy.optimize import linear_sum_assignment

    from ..runtime.eval_utils import _IOU_THRESH, _ap_from_matches, _heading_accuracy, _iou3d_np

    results = {}
    for cname in class_names:
        thr = _IOU_THRESH.get(cname, 0.5)
        acc = {g: [[], [], [], 0] for g in level_groups}
        for det, gt in zip(det_annos, gt_annos):
            det_mask = np.asarray(det["name"]) == cname
            d_boxes = np.asarray(det["boxes_lidar"], np.float32)[det_mask]
            d_scores = np.asarray(det["score"], np.float32)[det_mask]
            gt_names = np.asarray(gt.get("name", []))
            g_mask = gt_names == cname
            g_boxes = np.asarray(gt.get("gt_boxes_lidar", np.zeros((0, 7))), np.float32)[g_mask]
            levels = ii_difficulty_levels(gt.get("interaction_index", {}), len(gt_names))[g_mask]
            iou = _iou3d_np(d_boxes[:, :7], g_boxes[:, :7])
            match_gt = np.full(len(d_boxes), -1, np.int64)
            if iou.size:
                for i, j in zip(*linear_sum_assignment(-iou)):
                    if iou[i, j] >= thr:
                        match_gt[i] = j
            mm = match_gt >= 0
            hacc = np.zeros(len(d_boxes))
            if mm.any():
                hacc[mm] = _heading_accuracy(d_boxes[mm, 6], g_boxes[match_gt[mm], 6])
            for group in level_groups:
                gsel = np.isin(levels, np.asarray(group))
                care = ~mm | gsel[np.clip(match_gt, 0, None)]
                tp = mm & gsel[np.clip(match_gt, 0, None)]
                acc[group][0].append(d_scores[care])
                acc[group][1].append(tp[care].astype(np.float64))
                acc[group][2].append((hacc * tp)[care])
                acc[group][3] += int(gsel.sum())
        for group in level_groups:
            s, t, h, ng = acc[group]
            ap, aph = _ap_from_matches(np.concatenate(s) if s else np.zeros(0),
                                       np.concatenate(t) if t else np.zeros(0),
                                       np.concatenate(h) if h else np.zeros(0), ng)
            tag = "II_" + "_".join(str(g) for g in group)
            results[f"{cname}/{tag}/AP"] = ap
            results[f"{cname}/{tag}/APH"] = aph
    result_str = "\n".join(f"{k}: {v:.4f}" for k, v in sorted(results.items()))
    return result_str, results
