"""Rotated 3D box corners and membership (counterpart of
pcseqlearning_tpu.ops.boxes.boxes_to_corners_3d / points_in_boxes). Box
convention (OpenPCDet):
[x, y, z, dx, dy, dz, heading], (x, y, z) the geometric center, heading a
counter-clockwise rotation around +z."""

from __future__ import annotations

import torch

# corner signs (x, y, z) of the reference template, halved below
_CORNERS = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
            (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def boxes_to_corners_3d(boxes):
    """[B, 7] -> [B, 8, 3] corners: the half-extents times the template's
    signs, rotated by the heading, translated to the center."""
    template = torch.tensor(_CORNERS, dtype=boxes.dtype, device=boxes.device) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    cosa, sina = torch.cos(boxes[:, 6])[:, None], torch.sin(boxes[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y, corners[..., 2]], dim=-1) + boxes[:, None, 0:3]


def points_in_boxes(points_xyz, boxes, margin=1e-2):
    """[..., B, N] bool — point n inside rotated box b.

    points_xyz [..., N, 3], boxes [..., B, 7] (leading dims broadcast).
    |z - cz| <= dz/2, and x/y within half-dims + margin after rotating by
    -heading."""
    p = points_xyz[..., None, :, :]
    bx = boxes[..., :, None, :]
    px = p[..., 0] - bx[..., 0]
    py = p[..., 1] - bx[..., 1]
    pz = p[..., 2] - bx[..., 2]
    rz = bx[..., 6]
    cosa, sina = torch.cos(-rz), torch.sin(-rz)
    local_x = px * cosa + py * (-sina)
    local_y = px * sina + py * cosa
    in_z = pz.abs() <= bx[..., 5] / 2.0
    in_x = local_x.abs() < bx[..., 3] / 2.0 + margin
    in_y = local_y.abs() < bx[..., 4] / 2.0 + margin
    return in_z & in_x & in_y
