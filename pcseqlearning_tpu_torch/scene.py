"""Synthetic scenes, so that the port's smoke run and tests need neither
``bench.py`` nor ``jax``.

``make_scene`` (a copy of ``bench.make_scene``): a static ground surface
(65% of the points, the same cells every frame) plus 24 rigid Gaussian
clusters: even-indexed ones move at 0.15-0.8 m/frame, the rest drift below
the 0.05 m/frame moving threshold. ``scene_dict`` is its pipeline input
dict and ``scene_batch`` a collated SimpleReg batch of such sequences.
``make_rigid_scene`` (a copy of tests/test_registration_oracle.py's) is a
two-frame registration problem with a known rigid motion per cluster.
``write_waymo_sequence`` writes such a scene to disk in the layout that
``datasets.WaymoDataset`` reads. ``bench_detector_batch`` is
``bench.py::bench_detector``'s batch for ``DETECTOR_CFG`` (CenterPoint).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


def make_scene(num_frames=20, points_per_frame=90_000, seed=0, moving_fraction=0.5):
    """Returns (seq [F * points_per_frame, 4] float32 (frame, x, y, z),
    gt dict of per-frame boxes, track ids, velocities and moving flags)."""
    rng = np.random.RandomState(seed)
    frames = []
    n_clusters = 24
    centers = rng.rand(n_clusters, 2) * 120 - 60
    n_moving = int(round(n_clusters * moving_fraction))
    velo = np.zeros((n_clusters, 2))
    ang = rng.rand(n_moving) * 2 * np.pi
    spd = rng.rand(n_moving) * 0.65 + 0.15
    velo[:n_moving] = np.stack([np.cos(ang), np.sin(ang)], 1) * spd[:, None]
    velo[n_moving:] = rng.randn(n_clusters - n_moving, 2) * 0.01
    sizes = rng.rand(n_clusters) * 1.5 + 0.5
    gt_attr, gt_frame, gt_track = [], [], []
    n_ground = int(points_per_frame * 0.65)
    gx_fixed = rng.rand(n_ground, 2) * 150 - 75
    gz_fixed = 0.02 * np.sin(gx_fixed[:, 0] / 10) + rng.randn(n_ground) * 0.02
    ground = np.stack([gx_fixed[:, 0], gx_fixed[:, 1], gz_fixed], axis=1)
    for f in range(num_frames):
        objs = []
        per = (points_per_frame - n_ground) // n_clusters
        for c in range(n_clusters):
            pos = centers[c] + velo[c] * f
            pts = rng.randn(per, 3) * sizes[c] * np.array([1, 1, 0.5])
            pts[:, :2] += pos
            pts[:, 2] += sizes[c] + 0.5
            objs.append(pts)
            gt_attr.append([pos[0], pos[1], sizes[c] + 0.5, 4 * sizes[c], 4 * sizes[c],
                            2 * sizes[c], 0.0])
            gt_frame.append(f)
            gt_track.append(c)
        xyz = np.concatenate([ground] + objs).astype(np.float32)
        fcol = np.full((len(xyz), 1), f, np.float32)
        frames.append(np.concatenate([fcol, xyz], axis=1))
    speed = np.linalg.norm(velo, axis=1)[np.asarray(gt_track)]
    gt = dict(
        gt_box_attr=np.asarray(gt_attr, np.float32),
        gt_box_frame=np.asarray(gt_frame, np.int64),
        gt_box_track_label=np.asarray(gt_track, np.int64),
        gt_box_cls_label=np.ones(len(gt_attr), np.int64),
        gt_box_velo=speed.astype(np.float32),
        moving=speed > 0.05,
    )
    return np.concatenate(frames), gt


def scene_dict(num_frames, points_per_frame, seed=0, frame_id="seq_000"):
    """The pipeline's input dict for ``make_scene`` (as bench.py and the
    parity harness build it)."""
    seq, gt = make_scene(num_frames=num_frames, points_per_frame=points_per_frame, seed=seed)
    return {
        "point_fxyz": seq,
        "point_sweep": seq[:, 0].astype(np.int64),
        "point_feat": np.zeros((len(seq), 1), np.float32),
        "frame_id": frame_id,
        **gt,
    }


def scene_batch(num_frames, points_per_frame, seeds=(0,), name="seq"):
    """A collated batch of ``make_scene`` sequences in SimpleReg's input
    layout: point_bxyz [N, 4] (sequence index, x, y, z), point_sweep and
    point_feat [N], and per sequence the boxes padded per frame,
    gt_box_attr [B, F * 24, 7], gt_box_cls_label and obj_ids [B, F * 24],
    frame_id [B] ("<name>_<b>.npy")."""
    bxyz, sweep, attr, cls, obj = [], [], [], [], []
    for b, seed in enumerate(seeds):
        seq, gt = make_scene(num_frames=num_frames, points_per_frame=points_per_frame, seed=seed)
        bxyz.append(np.concatenate([np.full((len(seq), 1), b, np.float32), seq[:, 1:4]], axis=1))
        sweep.append(seq[:, 0].astype(np.int64))
        attr.append(gt["gt_box_attr"])
        cls.append(gt["gt_box_cls_label"])
        obj.append(np.asarray([f"obj_{t}" for t in gt["gt_box_track_label"]]))
    return {
        "batch_size": len(seeds),
        "point_bxyz": np.concatenate(bxyz),
        "point_sweep": np.concatenate(sweep),
        "point_feat": np.zeros((sum(len(s) for s in sweep), 1), np.float32),
        "gt_box_attr": np.stack(attr),
        "gt_box_cls_label": np.stack(cls),
        "obj_ids": np.stack(obj),
        "frame_id": [f"{name}_{b:03d}.npy" for b in range(len(seeds))],
    }


def make_rigid_scene(seed, C=5, per=60, rot_deg=8.0, trans=0.4):
    """C clusters 14 m apart (far beyond any registration radius) and their
    images under one rigid motion each (a rotation about the cluster center
    up to ``rot_deg`` degrees, a translation up to ``trans`` m). Returns
    (moving [C * per, 3] f32, comp [C * per] int32, ref [C * per, 3] f32,
    gt_T [C, 4, 4] f64)."""
    rng = np.random.RandomState(seed)
    centers = np.stack([np.arange(C) * 14.0, (np.arange(C) % 2) * 14.0, np.zeros(C)], 1)
    centers = centers + rng.randn(C, 3)
    pts, comp, gt_T = [], [], []
    for c in range(C):
        p = centers[c] + rng.randn(per, 3) * np.array([1.2, 1.0, 0.5])
        ang = np.deg2rad(rng.uniform(-rot_deg, rot_deg))
        ca, sa = np.cos(ang), np.sin(ang)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
        t = rng.uniform(-trans, trans, 3)
        pts.append((p, (p - centers[c]) @ R.T + centers[c] + t))
        comp.append(np.full(per, c))
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = centers[c] - R @ centers[c] + t
        gt_T.append(M)
    moving = np.concatenate([p for p, _ in pts]).astype(np.float32)
    ref = np.concatenate([q for _, q in pts]).astype(np.float32)
    return moving, np.concatenate(comp).astype(np.int32), ref, np.stack(gt_T)


def write_waymo_sequence(root, frames, gt, name, processed_data_tag="waymo_processed_data_v0_5_0"):
    """Write a ``make_scene`` sequence (``frames`` [N, 4] (frame, x, y, z),
    ``gt`` its box dict) as the Waymo sequence ``name`` under ``root``, in
    the layout of ``tools/create_waymo_infos.py``:

      <root>/<processed_data_tag>/<name>/NNNN.npy      [n, 8] float32: x, y, z
          and zeros for intensity, elongation, range, rimage_w, rimage_h
      <root>/<processed_data_tag>/<name>/NNNN_seg.npy  [n, 2] int64
          (instance, class): a point inside a GT box gets the box's track id
          and class 1 (Vehicle), every other point -1 and 18 (ground)
      <root>/<processed_data_tag>/<name>/<name>.pkl    one info dict a frame:
          point_cloud, frame_id "<name>_<idx:03d>", identity pose, and annos
          (name, gt_boxes_lidar, obj_ids, num_points_in_gt)

    Returns the sequence directory."""
    from .ops.boxes import points_in_boxes

    seq_dir = Path(root) / processed_data_tag / name
    seq_dir.mkdir(parents=True, exist_ok=True)
    fid = frames[:, 0].astype(np.int64)
    infos = []
    for f in range(int(fid.max()) + 1):
        xyz = frames[fid == f, 1:4].astype(np.float32)
        b = np.nonzero(gt["gt_box_frame"] == f)[0]
        boxes = gt["gt_box_attr"][b].astype(np.float32)
        tracks = gt["gt_box_track_label"][b]
        inside = points_in_boxes(torch.as_tensor(xyz), torch.as_tensor(boxes)).numpy()  # [B, n]
        in_any = inside.any(0)
        seg = np.stack([np.where(in_any, tracks[inside.argmax(0)], -1),
                        np.where(in_any, 1, 18)], axis=1).astype(np.int64)
        pts = np.zeros((len(xyz), 8), np.float32)
        pts[:, :3] = xyz
        np.save(seq_dir / ("%04d.npy" % f), pts)
        np.save(seq_dir / ("%04d_seg.npy" % f), seg)
        infos.append(dict(
            point_cloud=dict(lidar_sequence=name, sample_idx=f),
            frame_id=f"{name}_{f:03d}",
            pose=np.eye(4),
            annos=dict(
                name=np.asarray(["Vehicle"] * len(b)),
                gt_boxes_lidar=boxes,
                obj_ids=np.asarray([f"obj_{t}" for t in tracks]),
                num_points_in_gt=inside.sum(1).astype(np.int64),
            ),
        ))
    with open(seq_dir / f"{name}.pkl", "wb") as fo:
        pickle.dump(infos, fo)
    return seq_dir


DETECTOR_CFG = "tools/cfgs/waymo_models/centerpoint.yaml"


def bench_detector_batch(batch_size, n_points, extent, seed=0):
    """bench.py's detector batch (bench_detector): uniform points over
    +-``extent`` m, z in [-1.5, 3.5], one feature, 64 car-sized GT boxes a
    sample, all drawn from RandomState(seed) in bench.py's order."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n_points, 4), np.float32)
    pts[..., 1] = rng.rand(batch_size, n_points) * 2 * extent - extent
    pts[..., 2] = rng.rand(batch_size, n_points) * 2 * extent - extent
    pts[..., 3] = rng.rand(batch_size, n_points) * 5 - 1.5
    feats = rng.rand(batch_size, n_points, 1).astype(np.float32)
    gt = np.zeros((batch_size, 64, 8), np.float32)
    for b in range(batch_size):
        gt[b, :, 0:2] = rng.rand(64, 2) * (2 * extent - 20) - (extent - 10)
        gt[b, :, 2] = 1.0
        gt[b, :, 3:6] = [4.5, 2.0, 1.8]
        gt[b, :, 7] = rng.randint(1, 4, 64)
    return dict(points=pts, feats=feats, valid=np.ones((batch_size, n_points), bool),
                gt_boxes=gt)
