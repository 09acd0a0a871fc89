"""The synthetic benchmark scene (a copy of ``bench.make_scene``), so that the
port's smoke run and tests need neither ``bench.py`` nor ``jax``.

A static ground surface (65% of the points, the same cells every frame)
plus 24 rigid Gaussian clusters: even-indexed ones move at 0.15-0.8
m/frame, the rest drift below the 0.05 m/frame moving threshold.
"""

from __future__ import annotations

import numpy as np


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
