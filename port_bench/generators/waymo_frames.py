"""Waymo-geometry lidar frames, ray-cast in plain torch on the device.

A frozen copy of the sensor geometry of the port's ``scene.WAYMO_LIDARS``
(TOP: 64 beams x 2,650 columns at per-beam inclinations; four short-range
lidars: 200 x 600 over an inclination range, yawed mounts), cast against a
world made from the seed: the ground plane z = 0, labelled boxes of the
traffic's classes at their class sizes on a polar grid of slots, and large
structures at the edges. Every ray is kept with its lidar's return share;
a kept ray returns where it first meets the world within ``max_range``.

Each point carries the five features of ``detection_1sweep.yaml``: x, y, z
(``points``), intensity and elongation (``feats``). The points outside the
configuration's range are dropped and the rest shuffled, as the data
processors ``mask_points_and_boxes_outside_range`` and ``shuffle_points``
do; the labels are the world's boxes whose centre is in range.

Frames are in the port's dense batch layout: ``points`` [P, B, N, 4]
(column 0 zero), ``feats`` [P, B, N, 2], ``valid`` [P, B, N] and
``gt_boxes`` [P, B, G, 8] (x, y, z, l, w, h, heading, class from 1; zero
rows pad), for a pool of P batches of B frames, N the configuration's
POINT_CAP.
"""

from __future__ import annotations

import math

import torch

RAY_CHUNK = 1 << 16


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def _rays(lidar, g, device):
    """(origins [R, 3], directions [R, 3]) of the lidar's kept rays, float64."""
    rows, cols = int(lidar["rows"]), int(lidar["cols"])
    lo, hi = lidar["inclination"]
    frac = torch.arange(rows, device=device, dtype=torch.float64) + 0.5
    if lidar["per_beam"]:  # beams jittered by up to 0.3 of their spacing, as the scene does
        frac = frac + _uniform(g, rows, -0.3, 0.3, device)
    incl = torch.sort(lo + (hi - lo) * frac / rows).values
    az = (1.0 - 2.0 * (torch.arange(cols, device=device, dtype=torch.float64) + 0.5) / cols) * math.pi
    az = az + float(lidar["yaw"])
    keep = torch.rand((rows, cols), generator=g, device=device) < float(lidar["share"])
    r_i, c_i = torch.nonzero(keep, as_tuple=True)
    inc, a = incl[r_i], az[c_i]
    d = torch.stack([torch.cos(inc) * torch.cos(a), torch.cos(inc) * torch.sin(a), torch.sin(inc)], 1)
    o = torch.tensor(lidar["mount"], dtype=torch.float64, device=device).expand_as(d)
    return o, d


def _world(traffic, g, device):
    """The frame's boxes [M, 7] (cx, cy, cz, l, w, h, heading) float64 and
    class ids [M] (0 for a structure), the labelled ones first."""
    obj, st = traffic["objects"], traffic["structures"]
    # polar slots of ``slot`` m, one object a slot, so no two objects overlap
    slot = float(obj["slot"])
    centres = []
    r = float(obj["r_min"]) + slot / 2
    while r <= float(obj["r_max"]):
        n = int(2 * math.pi * r // slot)
        ang = 2 * math.pi * (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
        centres.append(torch.stack([r * torch.cos(ang), r * torch.sin(ang)], 1))
        r += slot
    centres = torch.cat(centres)
    count = int(obj["count"])
    if count > centres.shape[0]:
        raise ValueError(f"{count} objects do not fit {centres.shape[0]} slots")
    pick = torch.randperm(centres.shape[0], generator=g, device=device)[:count]
    xy = centres[pick] + _uniform(g, (count, 2), -1.0, 1.0, device) * float(obj["jitter"])
    shares = torch.tensor([c["share"] for c in obj["classes"]], dtype=torch.float64, device=device)
    cls = torch.multinomial(shares, count, replacement=True, generator=g)
    cls[:len(obj["classes"])] = torch.arange(min(len(obj["classes"]), count), device=device)
    sizes = torch.tensor([c["size"] for c in obj["classes"]], dtype=torch.float64, device=device)
    lwh = sizes[cls] * (1 + float(obj["size_jitter"]) * _uniform(g, (count, 3), -1, 1, device))
    heading = _uniform(g, count, -math.pi, math.pi, device)
    boxes = torch.cat([xy, lwh[:, 2:3] / 2, lwh, heading[:, None]], 1)
    # structures: long boxes at the edges, facing the sensor
    m = int(st["count"])
    ang = _uniform(g, m, -math.pi, math.pi, device)
    rad = _uniform(g, m, st["r_min"], st["r_max"], device)
    slwh = torch.stack([_uniform(g, m, *st["length"], device), _uniform(g, m, *st["width"], device),
                        _uniform(g, m, *st["height"], device)], 1)
    sbox = torch.cat([torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], 1),
                      slwh[:, 2:3] / 2, slwh, (ang + math.pi / 2)[:, None]], 1)
    return torch.cat([boxes, sbox]), torch.cat([cls + 1, torch.zeros(m, dtype=cls.dtype,
                                                                     device=device)])


def _cast(o, d, boxes, max_range):
    """Distance along each ray to the first surface (inf for none):
    the ground z = 0 and the boxes' slabs, in chunks of rays."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    half = boxes[:, 3:6] / 2
    out = []
    for i in range(0, o.shape[0], RAY_CHUNK):
        oo, dd = o[i:i + RAY_CHUNK], d[i:i + RAY_CHUNK]
        t_ground = torch.where(dd[:, 2] < 0, -oo[:, 2] / dd[:, 2].clamp(max=-1e-12),
                               torch.full_like(dd[:, 2], math.inf))
        rel = oo[:, None, :] - boxes[None, :, :3]
        # into each box's frame (rotation about z by -heading)
        px, py = c * rel[..., 0] + s * rel[..., 1], -s * rel[..., 0] + c * rel[..., 1]
        vx, vy = c * dd[:, None, 0] + s * dd[:, None, 1], -s * dd[:, None, 0] + c * dd[:, None, 1]
        p = torch.stack([px, py, rel[..., 2]], -1)
        v = torch.stack([vx, vy, dd[:, None, 2].expand_as(vx)], -1)
        v = torch.where(v.abs() < 1e-12, torch.full_like(v, 1e-12), v)
        t1, t2 = (-half - p) / v, (half - p) / v
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        hit = (near <= far) & (near > 0)
        t_box = torch.where(hit, near, torch.full_like(near, math.inf)).amin(-1)
        t = torch.minimum(t_ground, t_box)
        out.append(torch.where(t <= max_range, t, torch.full_like(t, math.inf)))
    return torch.cat(out)


def make_frame(traffic, pcr, g, device):
    """One frame: (points [n, 3] float32, feats [n, 2] float32, labels
    [m, 8] float32), the points in range and shuffled."""
    boxes, cls = _world(traffic, g, device)
    pts = []
    for lidar in traffic["lidars"]:
        o, d = _rays(lidar, g, device)
        t = _cast(o, d, boxes, float(traffic["max_range"]))
        ok = torch.isfinite(t)
        t = t[ok] + float(traffic["range_noise_m"]) * torch.randn(int(ok.sum()), generator=g,
                                                                 device=device,
                                                                 dtype=torch.float64)
        pts.append(o[ok] + t[:, None] * d[ok])
    xyz = torch.cat(pts)
    lo = torch.tensor(pcr[:3], dtype=torch.float64, device=device)
    hi = torch.tensor(pcr[3:], dtype=torch.float64, device=device)
    xyz = xyz.float()
    keep = ((xyz.double() >= lo) & (xyz.double() < hi)).all(1)
    xyz = xyz[keep]
    n = xyz.shape[0]
    feats = torch.stack([torch.rand(n, generator=g, device=device),
                         float(traffic["elongation_max"]) * torch.rand(n, generator=g,
                                                                       device=device)], 1)
    order = torch.randperm(n, generator=g, device=device)
    labelled = cls > 0
    lab = torch.cat([boxes[labelled], cls[labelled, None].double()], 1)
    inside = ((lab[:, :3] >= lo) & (lab[:, :3] < hi)).all(1)
    return xyz[order], feats[order], lab[inside].float()


def make_pool(traffic, cfg, seed, device):
    """The pool of ``traffic["pool"]`` batches of ``traffic["batch"]`` frames
    from ``seed``, in the dense layout, with per-frame point counts."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pcr = [float(v) for v in cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"]]
    n_cap, g_cap = int(cfg["MODEL"]["POINT_CAP"]), int(traffic["max_gt"])
    P, B = int(traffic["pool"]), int(traffic["batch"])
    points = torch.zeros((P, B, n_cap, 4), dtype=torch.float32, device=device)
    feats = torch.zeros((P, B, n_cap, 2), dtype=torch.float32, device=device)
    valid = torch.zeros((P, B, n_cap), dtype=torch.bool, device=device)
    gt = torch.zeros((P, B, g_cap, 8), dtype=torch.float32, device=device)
    returns = []
    for p in range(P):
        for b in range(B):
            xyz, f, lab = make_frame(traffic, pcr, g, device)
            n, m = min(xyz.shape[0], n_cap), min(lab.shape[0], g_cap)
            points[p, b, :n, 1:] = xyz[:n]
            feats[p, b, :n] = f[:n]
            valid[p, b, :n] = True
            gt[p, b, :m] = lab[:m]
            returns.append(int(xyz.shape[0]))
    return dict(points=points, feats=feats, valid=valid, gt_boxes=gt, returns=returns)
