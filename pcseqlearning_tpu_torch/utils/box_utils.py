"""Host NumPy box utilities (counterpart of pcseqlearning_tpu.utils.box_utils):
box corners, range masks, box enlargement and the axis-aligned nearest-BEV
IoU that ``gt_sampling`` rejects collisions with. The torch corners live in
``ops.boxes.boxes_to_corners_3d``.
"""

from __future__ import annotations

import numpy as np


def boxes_to_corners_3d_np(boxes):
    """[N, 7+] boxes -> [N, 8, 3] corners, in ``ops.boxes``' corner order."""
    template = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
                        dtype=np.float32) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    return np.stack([x, y, corners[..., 2]], axis=-1) + boxes[:, None, 0:3]


def mask_boxes_outside_range(boxes, limit_range, min_num_corners=1):
    """[N] bool: boxes with at least ``min_num_corners`` corners inside the
    range's x and y limits."""
    corners = boxes_to_corners_3d_np(boxes[:, :7])
    lr = np.asarray(limit_range)
    inside = ((corners[..., 0] >= lr[0]) & (corners[..., 0] <= lr[3])
              & (corners[..., 1] >= lr[1]) & (corners[..., 1] <= lr[4]))
    return inside.sum(axis=1) >= min_num_corners


def enlarge_box3d(boxes, extra_width=(0, 0, 0)):
    """A copy of ``boxes`` with each size grown by twice ``extra_width``."""
    out = np.array(boxes, copy=True)
    out[:, 3:6] += np.asarray(extra_width) * 2
    return out


def boxes3d_lidar_to_aligned_bev_boxes(boxes):
    """[N, 7] -> [N, 4] (x1, y1, x2, y2): each box's BEV extent with its
    heading rounded to the nearest axis."""
    rot = np.abs(np.remainder(boxes[:, 6], np.pi))
    swap = (rot > np.pi / 4) & (rot < 3 * np.pi / 4)
    dx = np.where(swap, boxes[:, 4], boxes[:, 3])
    dy = np.where(swap, boxes[:, 3], boxes[:, 4])
    return np.stack([boxes[:, 0] - dx / 2, boxes[:, 1] - dy / 2,
                     boxes[:, 0] + dx / 2, boxes[:, 1] + dy / 2], axis=1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """[A, B] IoU of the axis-aligned BEV extents."""
    a = boxes3d_lidar_to_aligned_bev_boxes(boxes_a)
    b = boxes3d_lidar_to_aligned_bev_boxes(boxes_b)
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]), 0)
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]), 0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-6)
