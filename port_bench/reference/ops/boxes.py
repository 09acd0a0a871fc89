"""Rotated 3D box corners, membership and IoU (counterpart of
pcseqlearning_tpu.ops.boxes: boxes_to_corners_3d, points_in_boxes,
boxes_overlap_bev, boxes_iou_bev, boxes_iou3d). Box convention (OpenPCDet):
[x, y, z, dx, dy, dz, heading], (x, y, z) the geometric center, heading a
counter-clockwise rotation around +z.

The IoUs are the JAX module's arithmetic in plain PyTorch on the tensors'
device: each pair's BEV rectangles are clipped one against the other
(Sutherland-Hodgman, into polygons of a fixed 16 slots, compacted by a sort
of the emitted vertices' positions), the intersection's area is the
shoelace sum, and the 3D overlap multiplies it by the z-extents' overlap.
The JAX package computes them in XLA, with no Pallas kernel; so does this
module.

NMS (``nms_bev``, ``nms_normal_bev``) keeps JAX's greedy rule exactly: the
boxes sorted by score (stably, padded rows last), row i, if still kept,
suppresses every row j != i with iou[i, j] > threshold, earlier rows
included (the IoU is not exactly symmetric). JAX runs that as a loop over
all rows on the device; here the [K, K] mask ``iou > threshold`` is formed
on the tensors' device (``iou_bev_above``: the rotated IoU only for the
pairs whose circumscribed circles meet, the others' IoU being 0, in chunks
of at most ``NMS_PAIRS_PER_CHUNK`` pairs, so that the clipping's
temporaries stay small; each pair is computed alone, so neither changes a
value), is copied to the host once, and one pass over it visits only the
kept rows: no device operation per row."""

from __future__ import annotations

import numpy as np
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


def _bev_corners(boxes):
    """[B, 7] -> [B, 4, 2] BEV rectangle corners, counter-clockwise."""
    dx, dy = boxes[:, 3] / 2.0, boxes[:, 4] / 2.0
    local = torch.stack([torch.stack([dx, dy], -1), torch.stack([-dx, dy], -1),
                         torch.stack([-dx, -dy], -1), torch.stack([dx, -dy], -1)], dim=1)
    cosa, sina = torch.cos(boxes[:, 6])[:, None], torch.sin(boxes[:, 6])[:, None]
    x = local[..., 0] * cosa - local[..., 1] * sina
    y = local[..., 0] * sina + local[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[:, None, 0:2]


def _clip_polygon(poly, poly_n, a, b):
    """Clip the convex polygons ``poly`` [M, P, 2] (the first ``poly_n`` [M]
    vertices valid) by the half-plane left of the directed edges a -> b
    [M, 2]. Returns the clipped polygons in the same P slots and their
    vertex counts."""
    P = poly.shape[-2]
    idx = torch.arange(P, device=poly.device)
    nxt = torch.where(idx + 1 >= poly_n[:, None], 0, idx + 1)
    d = b - a
    rel = poly - a[:, None, :]
    side = d[:, None, 0] * rel[..., 1] - d[:, None, 1] * rel[..., 0]  # > 0: inside (left)
    inside = side >= -1e-8
    nxt_v = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    nxt_side = torch.gather(side, 1, nxt)
    nxt_inside = nxt_side >= -1e-8
    denom = side - nxt_side
    t = side / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = poly + (nxt_v - poly) * t[..., None]
    valid_v = idx[None, :] < poly_n[:, None]
    # each vertex emits itself (inside) and the crossing of its edge (if any)
    emit_self = inside & valid_v
    emit_inter = (inside != nxt_inside) & valid_v
    out_pts = torch.cat([poly, inter], dim=-2)
    out_ok = torch.cat([emit_self, emit_inter], dim=-1)
    pos = torch.cat([2 * idx, 2 * idx + 1])
    order = torch.argsort(torch.where(out_ok, pos, 10 * P), dim=-1)
    out_pts = torch.gather(out_pts, 1, order[..., None].expand(-1, -1, 2))
    out_ok_sorted = torch.gather(out_ok, 1, order)
    out_n = out_ok.sum(-1)
    out_pts = torch.where(out_ok_sorted[..., None], out_pts, torch.zeros_like(out_pts))[:, :P]
    return out_pts, torch.clamp(out_n, max=P)


def _polygon_area(poly, n_valid):
    """Shoelace area of the first ``n_valid`` vertices of each polygon."""
    P = poly.shape[-2]
    idx = torch.arange(P, device=poly.device)
    nxt = torch.where(idx + 1 >= n_valid[:, None], 0, idx + 1)
    nxt_v = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cross = poly[..., 0] * nxt_v[..., 1] - poly[..., 1] * nxt_v[..., 0]
    valid = idx[None, :] < n_valid[:, None]
    return torch.where(valid, cross, torch.zeros_like(cross)).sum(-1).abs() / 2.0


def _pair_overlap(ca, cb):
    """Intersection areas [M] of the rectangle pairs with corners ca, cb
    [M, 4, 2]."""
    m = ca.shape[0]
    # a 4-gon clipped by four half-planes has at most 8 vertices; 16 slots
    poly = torch.cat([ca, ca.new_zeros(m, 12, 2)], dim=1)
    n = torch.full((m,), 4, dtype=torch.int64, device=ca.device)
    for e in range(4):
        poly, n = _clip_polygon(poly, n, cb[:, e], cb[:, (e + 1) % 4])
    return _polygon_area(poly, n)


def boxes_overlap_bev(boxes_a, boxes_b):
    """[A, B] BEV intersection areas of rotated boxes [A, 7] and [B, 7]."""
    ca, cb = _bev_corners(boxes_a), _bev_corners(boxes_b)
    A, B = boxes_a.shape[0], boxes_b.shape[0]
    return _pair_overlap(ca[:, None].expand(A, B, 4, 2).reshape(A * B, 4, 2),
                         cb[None].expand(A, B, 4, 2).reshape(A * B, 4, 2)).reshape(A, B)


def boxes_iou_bev(boxes_a, boxes_b):
    """[A, B] rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-7)


def boxes_iou3d(boxes_a, boxes_b):
    """[A, B] 3D IoU: the rotated BEV overlap times the z-extents' overlap."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1, za2 = boxes_a[:, 2] - boxes_a[:, 5] / 2.0, boxes_a[:, 2] + boxes_a[:, 5] / 2.0
    zb1, zb2 = boxes_b[:, 2] - boxes_b[:, 5] / 2.0, boxes_b[:, 2] + boxes_b[:, 5] / 2.0
    zi = torch.clamp(torch.minimum(za2[:, None], zb2[None, :])
                     - torch.maximum(za1[:, None], zb1[None, :]), min=0.0)
    inter = inter_bev * zi
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-7)


# at most this many box pairs per chunk of the rotated IoU in NMS (each pair
# takes a few kB of temporaries in the polygon clipping)
NMS_PAIRS_PER_CHUNK = 1 << 20


def _greedy_keep(over, svalid):
    """JAX's suppression loop over the score-sorted rows, on the host:
    ``over`` [K, K] bool (iou > threshold), ``svalid`` [K]. Returns the
    sorted rows' keep mask (NumPy)."""
    over = over.cpu().numpy()
    np.fill_diagonal(over, False)
    keep = svalid.cpu().numpy().copy()
    for i in range(keep.shape[0]):
        if keep[i]:  # keep starts as svalid, so a kept row is valid
            keep &= ~over[i]
    return keep


def _nms(boxes, scores, valid, over_fn):
    b = boxes.shape[0]
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=boxes.device)
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.sort(-torch.where(valid, scores, neg_inf), stable=True).indices
    with torch.no_grad():
        keep_sorted = _greedy_keep(over_fn(boxes[order]), valid[order])
    keep = torch.zeros(b, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def iou_bev_above(boxes, iou_threshold):
    """[K, K] bool: ``boxes_iou_bev(boxes, boxes) > iou_threshold``, with
    the rotated IoU computed only for the pairs whose BEV circumscribed
    circles meet (a pair whose circles are apart has no overlap and an IoU
    of 0, the value it gets here), in chunks of at most
    ``NMS_PAIRS_PER_CHUNK`` pairs; each pair's arithmetic is
    ``boxes_iou_bev``'s."""
    per_chunk = NMS_PAIRS_PER_CHUNK
    k = boxes.shape[0]
    over = torch.full((k, k), 0.0 > iou_threshold, dtype=torch.bool, device=boxes.device)
    corners = _bev_corners(boxes)
    area = boxes[:, 3] * boxes[:, 4]
    ctr = boxes[:, 0:2]
    reach = 0.5 * torch.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    rows = max(1, per_chunk // max(k, 1))
    for r0 in range(0, k, rows):
        d2 = ((ctr[r0:r0 + rows, None] - ctr[None]) ** 2).sum(-1)
        r2 = (reach[r0:r0 + rows, None] + reach[None]) ** 2
        i, j = torch.nonzero(d2 <= r2 * 1.001 + 1e-4, as_tuple=True)  # a margin for rounding
        i = i + r0
        inter = _pair_overlap(corners[i], corners[j])
        over[i, j] = inter / torch.clamp(area[i] + area[j] - inter, min=1e-7) > iou_threshold
    return over


def nms_bev(boxes, scores, iou_threshold, valid=None):
    """Oriented BEV NMS: boxes [K, 7], scores [K], valid [K] (padded rows
    False). Returns keep [K] bool in the input order."""
    return _nms(boxes, scores, valid, lambda sboxes: iou_bev_above(sboxes, iou_threshold))


def nms_normal_bev(boxes, scores, iou_threshold, valid=None):
    """Axis-aligned NMS: the IoU of the boxes' BEV extents, heading
    ignored. Same contract as ``nms_bev``."""

    def over(sboxes):
        x1, x2 = sboxes[:, 0] - sboxes[:, 3] / 2.0, sboxes[:, 0] + sboxes[:, 3] / 2.0
        y1, y2 = sboxes[:, 1] - sboxes[:, 4] / 2.0, sboxes[:, 1] + sboxes[:, 4] / 2.0
        iw = torch.clamp(torch.minimum(x2[:, None], x2[None, :])
                         - torch.maximum(x1[:, None], x1[None, :]), min=0.0)
        ih = torch.clamp(torch.minimum(y2[:, None], y2[None, :])
                         - torch.maximum(y1[:, None], y1[None, :]), min=0.0)
        inter = iw * ih
        area = (x2 - x1) * (y2 - y1)
        return inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-7) > iou_threshold

    return _nms(boxes, scores, valid, over)
